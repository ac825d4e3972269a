#!/bin/bash
# Stop the training run of tools/run_stability_torch.sh cleanly: SIGTERM to
# the recorded pid (never a pattern match), the counterpart of
# tools/stop_stability.sh. The pid is GNU timeout's, which passes the
# signal on; the trainer finishes its tick, snapshots, runs the tick's
# metrics and exits.
#
# Env knob: STAB_PIDFILE (default /tmp/stab_train_torch.pid).
#
# Exit code: 0 when the run stopped (or was not running); 1 when it was
# still alive after WAIT seconds and its process group was killed.
set -u
PIDFILE="${STAB_PIDFILE:-/tmp/stab_train_torch.pid}"
WAIT=300  # a tick at full width is ~1 kimg of steps, then a ~5 GB snapshot and the metrics
if [ ! -f "$PIDFILE" ]; then
  echo "no $PIDFILE: nothing to stop"
  exit 0
fi
PID="$(cat "$PIDFILE")"
if ! kill -0 "$PID" 2>/dev/null; then
  echo "pid $PID not running: already stopped"
  rm -f "$PIDFILE"
  exit 0
fi
kill -TERM "$PID"
echo "sent SIGTERM to $PID; waiting up to $WAIT s for the exit..."
END=$((SECONDS + WAIT))
while [ "$SECONDS" -lt "$END" ]; do
  kill -0 "$PID" 2>/dev/null || { echo "stopped."; rm -f "$PIDFILE"; exit 0; }
  sleep 1
done
echo "still alive after $WAIT s; sending SIGKILL to the process group $PID"
# timeout leads its own process group (the trainer and its loader workers
# are in it): killing only $PID would orphan the trainer on the card.
kill -KILL -- "-$PID" 2>/dev/null || kill -KILL "$PID" 2>/dev/null
rm -f "$PIDFILE"
exit 1
