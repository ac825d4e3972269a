#!/bin/bash
# The real-data-scale rehearsal of the PyTorch port, offline: the
# counterpart of tools/run_production_rehearsal.sh. It pushes a
# production-shaped source tree through the path the reference's ad-banner
# set takes (reference dataset_tool.py:83-243):
#
#   1. python3 -m layoutdetr_tpu_torch.production_source: REH_PAGES pages
#      (default 7,672, the reference dataset's), IAB banner sizes up to
#      1024 px, 1-9 rendered elements, inpainting-like backgrounds;
#   2. python3 -m layoutdetr_tpu_torch.dataset_tool --png-compress 3: two
#      streaming passes, the first 90% of the pages to train.zip;
#   3. python3 -m layoutdetr_tpu_torch.train --load-patches --device-feed off
#      for REH_KIMG kimg: the full host I/O path (every element's patch,
#      patch_orig and mask decoded, as the reference's loader does), the
#      warm background cache (native fastdata) and forked prefetch workers,
#      on the card unless --device cpu is passed;
#   4. the summary: sec/kimg a tick and the median after the first tick.
#
# Steps 1 and 2 are skipped when their output exists. Each step's wall
# clock and peak RSS come from /usr/bin/time -v, or tools/peakrss.py where
# it is absent. Arguments given to this script go on to the trainer after
# its flags (the last of a repeated flag wins).
#
# Artifacts in REH_OUT: rehearsal_{source,convert,train}.log,
# rehearsal_stats.jsonl, rehearsal_summary.txt.
#
# Env knobs: REH_PAGES (default 7672), REH_KIMG (default 10), REH_ROOT (the
# source, the zips and the run; default /tmp/prod_rehearsal_torch), REH_OUT
# (default $REH_ROOT/out).
#
# Exit code: 0 when every step ran; 1 when a step failed (nothing after it
# runs); the trainer's code when it failed, 124 when its wall bound ended it.
set -u
cd "$(dirname "$0")/.."
PAGES="${REH_PAGES:-7672}"
KIMG="${REH_KIMG:-10}"
ROOT="${REH_ROOT:-/tmp/prod_rehearsal_torch}"
OUT="${REH_OUT:-$ROOT/out}"
TRAIN_WALL_S=5400
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p "$OUT" || exit 1
SUMMARY="$OUT/rehearsal_summary.txt"

if [ -x /usr/bin/time ]; then
  MTIME=(/usr/bin/time -v)
else
  MTIME=(python3 tools/peakrss.py --)
fi

mark() { echo "[rehearsal $(date -u +%H:%M:%S)] $*" | tee -a "$SUMMARY"; }
fail() { mark "$*"; exit 1; }

if [ ! -f "$ROOT/source/png_json_gt/page$(printf %06d $((PAGES - 1))).json" ]; then
  mark "generating $PAGES-page production-shaped source -> $ROOT/source"
  "${MTIME[@]}" python3 -m layoutdetr_tpu_torch.production_source \
    --out "$ROOT/source" --pages "$PAGES" \
    > "$OUT/rehearsal_source.log" 2>&1 || fail "source generation FAILED (see $OUT/rehearsal_source.log)"
  grep -E "Maximum resident|Elapsed|done:" "$OUT/rehearsal_source.log" | tee -a "$SUMMARY"
  du -sb "$ROOT/source" | tee -a "$SUMMARY"
fi

if [ ! -f "$ROOT/zips/train.zip" ]; then
  mark "python3 -m layoutdetr_tpu_torch.dataset_tool streaming convert -> $ROOT/zips"
  "${MTIME[@]}" python3 -m layoutdetr_tpu_torch.dataset_tool --source "$ROOT/source" \
    --dest "$ROOT/zips" --png-compress 3 \
    > "$OUT/rehearsal_convert.log" 2>&1 || fail "convert FAILED (see $OUT/rehearsal_convert.log)"
  grep -E "Maximum resident|Elapsed|Wrote" "$OUT/rehearsal_convert.log" | tee -a "$SUMMARY"
  du -b "$ROOT/zips"/*.zip | tee -a "$SUMMARY"
fi

# The loader decodes backgrounds with fastdata where it builds, else with
# PIL: build it here, so the rehearsal never measures PIL unasked.
python3 -c "from layoutdetr_tpu_torch.data import native; print('fastdata:', native.library()._name)" \
  2>&1 | tee -a "$SUMMARY"
[ "${PIPESTATUS[0]}" -eq 0 ] || fail "fastdata build FAILED"

mark "train $KIMG kimg with --load-patches --device-feed off (full host I/O path)"
rm -rf "$ROOT/runs"
"${MTIME[@]}" timeout --signal=TERM --kill-after=180 "$TRAIN_WALL_S" \
  python3 -m layoutdetr_tpu_torch.train \
  --outdir "$ROOT/runs" \
  --data "$ROOT/zips/train.zip" \
  --batch 16 --bf16 --kimg "$KIMG" --tick 1 --snap 100 \
  --metrics none --load-patches --device-feed off --desc rehearsal "$@" \
  > "$OUT/rehearsal_train.log" 2>&1
RC=$?
RUN_DIR=$(ls -d "$ROOT/runs"/0* 2>/dev/null | head -1)
[ -n "$RUN_DIR" ] && [ -f "$RUN_DIR/stats.jsonl" ] && cp "$RUN_DIR/stats.jsonl" "$OUT/rehearsal_stats.jsonl"
mark "train rc=$RC"
grep -E "Maximum resident|Elapsed|Background decode|Sample cache warmed|Kernel launches" \
  "$OUT/rehearsal_train.log" | tee -a "$SUMMARY"
if [ "$RC" -eq 124 ]; then
  mark "train stopped by its ${TRAIN_WALL_S} s wall bound (timeout 124) before $KIMG kimg"
  exit 124
fi
[ "$RC" -eq 0 ] || { mark "train FAILED (see $OUT/rehearsal_train.log)"; exit "$RC"; }
grep -q "^Background decode: native fastdata" "$OUT/rehearsal_train.log" \
  || fail "the trainer's loader did not decode with fastdata"
[ -f "$OUT/rehearsal_stats.jsonl" ] || fail "no stats.jsonl from the run"
python3 - "$OUT/rehearsal_stats.jsonl" <<'EOF' | tee -a "$SUMMARY"
import json, sys
rows = [json.loads(l) for l in open(sys.argv[1])]
sk = [r["sec_per_kimg"] for r in rows if "sec_per_kimg" in r]
if sk:
    post = sk[1:] or sk  # drop the first tick (one step and the first use of every kernel)
    med = sorted(post)[len(post) // 2]
    print(f"sec/kimg ticks: {[round(x, 1) for x in sk]}")
    print(f"post-compile median {med:.1f} s/kimg "
          f"= {1000.0 / med:.1f} imgs/s wall-clock with full patch I/O")
    feed = [r["feed_s"] for r in rows if "feed_s" in r]
    if feed:  # the host seconds a tick the loop waited on batches and issued their copies
        print(f"feed s a tick: {[round(x, 1) for x in feed]}")
EOF
[ "${PIPESTATUS[0]}" -eq 0 ] || fail "summary FAILED"
mark "rehearsal done"
