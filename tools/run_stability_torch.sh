#!/bin/bash
# A long training run of the PyTorch port: the counterpart of
# tools/run_stability.sh, with the same data, flags and knobs.
#
# Builds the structured synthetic banner zips (layoutdetr_tpu_torch/data/
# synthetic.py, structured mode: 1024 samples, seed 1; val.zip 128,
# seed 2; 256^2, 9 elements) unless they exist, then trains the full
# config (768-wide 12-layer BERT, T=256, 256^2 backgrounds, batch 16,
# bf16, ADA, no lazy regularizers: no --gamma, no --pl-weight) with the
# layout FID and the layout suite at snapshot ticks, on the card unless
# --device cpu is passed. Arguments given to this script go on to the
# trainer after these flags (the last of a repeated flag wins).
#
# Artifacts: $STAB_OUTDIR/<id>-data-batch16-stability/{stats.jsonl,
# metric-*.jsonl,log.txt,network-snapshot-NNNNNN.pt}; summarise each run
# directory with tools/stability_report.py.
#
# Usage:  nohup bash tools/run_stability_torch.sh > launch.log 2>&1 &
# Stop:   bash tools/stop_stability_torch.sh  (SIGTERM to the recorded pid:
#         the trainer finishes its tick, snapshots and exits)
# Resume: STAB_RESUME=<run_dir>/network-snapshot-NNNNNN.pt bash tools/run_stability_torch.sh
#         (a new run directory; --resume-kimg NNNNNN from the name)
#
# Env knobs: STAB_KIMG (default 200), STAB_MAX_HOURS (wall bound, default
# 6, fractions allowed; the run snapshots on the way out, so a bound loses
# at most the tick in flight), STAB_METRIC_TICKS (default 2), STAB_SNAP
# (ticks = kimg between snapshots, default 25), STAB_RESUME, STAB_OUTDIR
# (default runs_stability_torch), STAB_PIDFILE (default
# /tmp/stab_train_torch.pid).
#
# Exit code: the trainer's; 124 when STAB_MAX_HOURS ended the run (it
# snapshotted, but it did not reach STAB_KIMG).
set -u
cd "$(dirname "$0")/.."
KIMG="${STAB_KIMG:-200}"
MAX_HOURS="${STAB_MAX_HOURS:-6}"
METRIC_TICKS="${STAB_METRIC_TICKS:-2}"
SNAP="${STAB_SNAP:-25}"
OUTDIR="${STAB_OUTDIR:-runs_stability_torch}"
PIDFILE="${STAB_PIDFILE:-/tmp/stab_train_torch.pid}"
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

RESUME_ARGS=()
if [ -n "${STAB_RESUME:-}" ]; then
  NAME="$(basename "$STAB_RESUME")"
  if [[ ! "$NAME" =~ ^network-snapshot-([0-9]+)\.pt$ ]]; then
    echo "run_stability_torch: STAB_RESUME=$STAB_RESUME is not a network-snapshot-NNNNNN.pt" >&2
    exit 2
  fi
  RESUME_ARGS=(--resume "$STAB_RESUME" --resume-kimg "$((10#${BASH_REMATCH[1]}))")
fi

mkdir -p "$OUTDIR/data" || exit 1
if [ ! -f "$OUTDIR/data/train.zip" ]; then
  python3 - "$OUTDIR/data" <<'EOF' || { echo "run_stability_torch: dataset build FAILED" >&2; exit 1; }
import os, sys
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
d = sys.argv[1]
# val.zip first: a train.zip is the mark of a finished build
make_synthetic_zip(os.path.join(d, "val.zip"), num_samples=128, image_size=256,
                   max_elements=9, seed=2, structured=True)
make_synthetic_zip(os.path.join(d, "train.zip.tmp"), num_samples=1024, image_size=256,
                   max_elements=9, seed=1, structured=True)
os.replace(os.path.join(d, "train.zip.tmp"), os.path.join(d, "train.zip"))
print("dataset built")
EOF
fi

MAX_SECS="$(awk -v h="$MAX_HOURS" 'BEGIN{printf "%d", h*3600}')"
# The pidfile names GNU timeout, which forwards SIGTERM to the trainer
# and, with --kill-after, kills it if it ignores the signal; timeout
# leads its own process group, which stop_stability_torch.sh kills as a
# last resort.
timeout --signal=TERM --kill-after=180 "$MAX_SECS" python3 -m layoutdetr_tpu_torch.train \
  --outdir "$OUTDIR" \
  --data "$OUTDIR/data/train.zip" \
  --batch 16 --bf16 \
  --kimg "$KIMG" --tick 1 --snap "$SNAP" \
  --metric-ticks "$METRIC_TICKS" \
  --aug ada \
  --metrics layout_fid50k_val,overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val \
  --desc stability "${RESUME_ARGS[@]}" "$@" &
TRAINER=$!
echo "$TRAINER" > "$PIDFILE"
wait "$TRAINER"
RC=$?
# a stale pid could name another process by the time a stop tool reads it
[ "$(cat "$PIDFILE" 2>/dev/null)" = "$TRAINER" ] && rm -f "$PIDFILE"
if [ "$RC" -eq 124 ]; then
  echo "run_stability_torch: STAB_MAX_HOURS=$MAX_HOURS wall bound reached (timeout 124): the" \
       "trainer snapshotted and stopped before STAB_KIMG=$KIMG" >&2
fi
exit "$RC"
