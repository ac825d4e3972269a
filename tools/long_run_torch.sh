#!/bin/bash
# The port's long run in two pieces inside one bounded session on the card:
# tools/run_stability_torch.sh in the background, stopped with
# tools/stop_stability_torch.sh LONG_STOP_AT seconds after the start,
# resumed from its last snapshot with STAB_RESUME and bounded with
# STAB_MAX_HOURS so that it stops by LONG_END_BY seconds; then
# tools/stability_report.py on both run directories. Into LONG_OUT go each
# piece's stats.jsonl, metric-*.jsonl, log.txt and report (--markdown),
# the launchers' and the stop tool's output, the card's name and power
# limit and an nvidia-smi sample every 30 s (memory used, power, SM clock).
# Snapshots stay in STAB_OUTDIR.
#
# Usage:  LONG_OUT=out/stability_torch bash tools/long_run_torch.sh
# Env:    LONG_STOP_AT (default 1450), LONG_END_BY (default 3050), LONG_OUT
#         (default runs_stability_torch/long_run), and the launcher's
#         STAB_* knobs (STAB_SNAP, STAB_METRIC_TICKS, STAB_OUTDIR, ...).
#
# Exit code: 0 when piece 1 stopped cleanly and piece 2 ended at its
# STAB_KIMG or its wall bound (the launcher's 124, expected here); else 1.
set -u
cd "$(dirname "$0")/.."
STOP_AT="${LONG_STOP_AT:-1450}"
END_BY="${LONG_END_BY:-3050}"
export STAB_OUTDIR="${STAB_OUTDIR:-runs_stability_torch}"
OUT="${LONG_OUT:-$STAB_OUTDIR/long_run}"
mkdir -p "$OUT" || exit 1
START=$SECONDS
say() { echo "[long run +$((SECONDS - START)) s] $*" | tee -a "$OUT/long_run.txt"; }

SMI=
if command -v nvidia-smi > /dev/null; then
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
  nvidia-smi --query-gpu=timestamp,memory.used,power.draw,clocks.sm --format=csv -l 30 \
    > "$OUT/nvidia_smi.csv" 2>&1 &
  SMI=$!
fi
trap '[ -n "$SMI" ] && kill "$SMI" 2> /dev/null' EXIT

say "piece 1: tools/run_stability_torch.sh $*"
bash tools/run_stability_torch.sh "$@" > "$OUT/piece1_launch.log" 2>&1 &
PIECE1=$!
while [ $((SECONDS - START)) -lt "$STOP_AT" ] && kill -0 "$PIECE1" 2> /dev/null; do
  sleep 5
done
if kill -0 "$PIECE1" 2> /dev/null; then
  say "stopping piece 1"
  bash tools/stop_stability_torch.sh > "$OUT/stop.log" 2>&1
  STOP_RC=$?
else
  STOP_RC=none
fi
wait "$PIECE1"
RC1=$?
say "piece 1 ended: launcher rc $RC1, stop tool rc $STOP_RC"
[ "$RC1" -eq 0 ] && [ "$STOP_RC" = 0 ] || { say "piece 1 FAILED"; exit 1; }
RUN1="$(ls -d "$STAB_OUTDIR"/0*/ | sort | tail -1)"
SNAP="$(ls "$RUN1"network-snapshot-*.pt | sort | tail -1)"
[ -f "$SNAP" ] || { say "no snapshot in $RUN1"; exit 1; }

LEFT=$((END_BY - (SECONDS - START)))
[ "$LEFT" -gt 120 ] || { say "no time left for piece 2 ($LEFT s)"; exit 1; }
say "piece 2: STAB_RESUME=$SNAP, STAB_MAX_HOURS for $LEFT s"
STAB_RESUME="$SNAP" STAB_MAX_HOURS="$(awk -v s="$LEFT" 'BEGIN{print s / 3600}')" \
  bash tools/run_stability_torch.sh "$@" > "$OUT/piece2_launch.log" 2>&1
RC2=$?
say "piece 2 ended: launcher rc $RC2"
RUN2="$(ls -d "$STAB_OUTDIR"/0*/ | sort | tail -1)"

for piece in 1 2; do
  RUN="$RUN1"; [ "$piece" = 2 ] && RUN="$RUN2"
  mkdir -p "$OUT/piece$piece"
  cp "$RUN"stats.jsonl "$RUN"log.txt "$RUN"training_options.json "$OUT/piece$piece/"
  cp "$RUN"metric-*.jsonl "$OUT/piece$piece/" 2> /dev/null
  ls -l "$RUN"network-snapshot-*.pt > "$OUT/piece$piece/snapshots.txt"
  python3 tools/stability_report.py "$RUN" --markdown > "$OUT/piece$piece/report.md" 2>&1 \
    || { say "report of piece $piece FAILED"; exit 1; }
done
python3 tools/long_run_summary_torch.py "$OUT/piece1" "$OUT/piece2" --json "$OUT/summary.json" \
  > "$OUT/summary.txt" 2>&1 || { say "summary FAILED"; exit 1; }
[ "$RC2" -eq 0 ] || [ "$RC2" -eq 124 ] || { say "piece 2 FAILED"; exit 1; }
say "done"
