#!/bin/bash
# The port's rehearsal at the most pages one bounded session on the card
# holds. A 64-page sizing pre-run (python3 -m layoutdetr_tpu_torch.
# production_source, the dataset tool at --png-compress 3, warm_cache with
# fastdata and with PIL on its train.zip) gives the seconds and bytes a
# page; the rehearsal then takes the reference's 7,672 pages, or as many as
# fit REH_BUDGET_S seconds (from this script's start, REH_TRAIN_S of them
# set aside for the trainer's start and its REH_KIMG kimg) and BUDGET_BYTES
# bytes of source and zips, and runs tools/run_production_rehearsal_torch.sh
# at that count; last, warm_cache with PIL on the rehearsal's train.zip (the
# trainer's own warm_cache, with fastdata, is in its log). Arguments go on
# to the trainer.
#
# Usage:  REH_OUT=out/rehearsal_torch bash tools/rehearsal_sized_torch.sh
# Env:    REH_BUDGET_S (default 2900), REH_TRAIN_S (default 600: on one H100
#         the trainer without patches runs ~50 sec/kimg, PERF.md), REH_KIMG
#         (default 2), REH_ROOT (default /tmp/prod_rehearsal_torch), REH_OUT
#         (default $REH_ROOT/out).
set -u
cd "$(dirname "$0")/.."
BUDGET_S="${REH_BUDGET_S:-2900}"
TRAIN_S="${REH_TRAIN_S:-600}"
BUDGET_BYTES=10737418240  # 10 GiB of the session's 45 GiB of writes
export REH_KIMG="${REH_KIMG:-2}"
export REH_ROOT="${REH_ROOT:-/tmp/prod_rehearsal_torch}"
export REH_OUT="${REH_OUT:-$REH_ROOT/out}"
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
PRE="$REH_ROOT/sizing"
START=$SECONDS
mkdir -p "$REH_OUT" || exit 1
command -v nvidia-smi > /dev/null \
  && nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$REH_OUT/card.txt"

# warm_cache of a train.zip with one decoder, in a process of its own: one JSON line
warm() {
  python3 - "$1" "$2" <<'EOF'
import json, sys
from layoutdetr_tpu_torch.data.dataset import LayoutDataset
zip_path, decoder = sys.argv[1], sys.argv[2]
ds = LayoutDataset(zip_path, cache=True, use_native=decoder == "native")
print(json.dumps({"zip": zip_path, "decoder": decoder, "pages": len(ds),
                  "warm_cache_s": ds.warm_cache()}))
EOF
}

rm -rf "$PRE" && mkdir -p "$PRE" || exit 1
T0=$SECONDS
python3 -m layoutdetr_tpu_torch.production_source --out "$PRE/source" --pages 64 \
  > "$PRE/source.log" 2>&1 || { echo "sizing: source FAILED"; exit 1; }
T1=$SECONDS
python3 -m layoutdetr_tpu_torch.dataset_tool --source "$PRE/source" --dest "$PRE/zips" \
  --png-compress 3 > "$PRE/convert.log" 2>&1 || { echo "sizing: convert FAILED"; exit 1; }
T2=$SECONDS
{ warm "$PRE/zips/train.zip" native && warm "$PRE/zips/train.zip" pil; } > "$PRE/warm.jsonl" \
  || { echo "sizing: warm_cache FAILED"; exit 1; }
PAGES="$(python3 - "$PRE" $((T1 - T0)) $((T2 - T1)) $((SECONDS - START)) "$BUDGET_S" \
  "$TRAIN_S" "$BUDGET_BYTES" "$REH_OUT/sizing.json" <<'EOF'
import json, os, sys
pre, src_s, tool_s, spent, budget_s, train_s, budget_bytes, out = sys.argv[1:]
src_s, tool_s, spent, budget_s, train_s = map(float, (src_s, tool_s, spent, budget_s, train_s))
nbytes = lambda d: sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(d) for n in ns)
warm = {w["decoder"]: w for w in map(json.loads, (line for line in open(
    os.path.join(pre, "warm.jsonl")) if line.startswith("{")))}  # the loader prints its decoder
share = warm["native"]["pages"] / 64  # the train zip's share of the pages
per_page_s = (src_s + tool_s) / 64 + share * sum(
    w["warm_cache_s"] / w["pages"] for w in warm.values())
per_page_bytes = (nbytes(os.path.join(pre, "source")) + nbytes(os.path.join(pre, "zips"))) / 64
by_time = int((budget_s - spent - train_s) / per_page_s)
by_bytes = int(float(budget_bytes) / per_page_bytes)
pages = min(7672, by_time, by_bytes)
json.dump(dict(source_s_per_page=src_s / 64, tool_s_per_page=tool_s / 64, warm=warm,
               per_page_s=per_page_s, per_page_bytes=per_page_bytes, train_s=train_s,
               pages_by_time=by_time, pages_by_bytes=by_bytes, pages=pages), open(out, "w"),
          indent=1)
print(pages)
EOF
)" || { echo "sizing FAILED"; exit 1; }
echo "sizing: $PAGES pages ($REH_OUT/sizing.json), $((SECONDS - START)) s"
[ "$PAGES" -ge 64 ] || { echo "sizing: the budget leaves no time for pages"; exit 1; }
cp "$PRE/warm.jsonl" "$REH_OUT/sizing_warm.jsonl"
rm -rf "$PRE"

REH_PAGES="$PAGES" bash tools/run_production_rehearsal_torch.sh "$@"
RC=$?
[ "$RC" -eq 0 ] || { echo "rehearsal FAILED (rc $RC)"; exit "$RC"; }
warm "$REH_ROOT/zips/train.zip" pil > "$REH_OUT/warm_cache_pil.jsonl" \
  || { echo "warm_cache with PIL FAILED"; exit 1; }
cat "$REH_OUT/warm_cache_pil.jsonl"
du -sb "$REH_ROOT/source" "$REH_ROOT/zips" | tee "$REH_OUT/bytes.txt"
echo "done in $((SECONDS - START)) s"
