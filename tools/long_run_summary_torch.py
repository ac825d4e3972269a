#!/usr/bin/env python3
"""Summarise a long run of the port made of pieces (``tools/long_run_torch.sh``):
what ``tools/stability_report.py`` gives per run directory, over the
pieces joined, plus what a long run is read for.

- sec/kimg over the ticks after each piece's first (which holds one step
  and the kernels' first use): median, quartiles, min and max, and the
  drift from the mean of the first five such ticks to the mean of the last
  five;
- the running peak of device memory (``devmem_peak_gb``), device memory in
  use (``devmem_gb``) and host peak RSS (``cpumem_gb``) at each piece's
  first and last tick;
- ``augment_p``: its values over the run;
- non-finite values among the stats' means;
- each trainer process's kernel launches at its end (``Kernel launches:``
  in its log.txt);
- each metric at each snapshot, in kimg order.

    python3 tools/long_run_summary_torch.py PIECE_DIR [PIECE_DIR ...] [--json OUT]

A piece directory holds ``stats.jsonl``, ``log.txt`` and ``metric-*.jsonl``
(a run directory, or a copy of one).
"""

import argparse
import glob
import json
import math
import os
import statistics

LAUNCH_LINE = "Kernel launches: "


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return dict(median=statistics.median(xs), q1=q[0], q3=q[2], min=min(xs), max=max(xs))


def summarise(pieces):
    out = dict(pieces=[], metrics={})
    steady = []  # (kimg, sec/kimg) after each piece's first tick
    augment = []
    bad = 0
    for d in pieces:
        rows = _jsonl(os.path.join(d, "stats.jsonl"))
        with open(os.path.join(d, "log.txt")) as f:
            launches = [json.loads(line[len(LAUNCH_LINE):]) for line in f
                        if line.startswith(LAUNCH_LINE)]
        steady += [(r["kimg"], r["sec_per_kimg"]) for r in rows[1:]]
        augment += [r["augment_p"] for r in rows if "augment_p" in r]
        bad += sum(1 for r in rows for v in r.values()
                   if isinstance(v, dict) and v.get("num") and not (
                       math.isfinite(v["mean"]) and math.isfinite(v["std"])))
        first, last = rows[0], rows[-1]
        out["pieces"].append(dict(
            dir=d, ticks=len(rows), kimg_first=first["kimg"], kimg_last=last["kimg"],
            first_tick_sec_per_kimg=first["sec_per_kimg"],
            devmem_peak_gb=(first["devmem_peak_gb"], last["devmem_peak_gb"]),
            devmem_gb=(first["devmem_gb"], last["devmem_gb"]),
            cpumem_gb=(first["cpumem_gb"], last["cpumem_gb"]),
            launches=launches[-1] if launches else None))
        for path in sorted(glob.glob(os.path.join(d, "metric-*.jsonl"))):
            for rec in _jsonl(path):
                digits = "".join(c for c in os.path.basename(rec["snapshot_path"]) if c.isdigit())
                for k, v in rec["results"].items():
                    out["metrics"].setdefault(k, []).append((int(digits), v))
    secs = [s for _, s in steady]
    out["sec_per_kimg"] = None
    if secs:
        first5, last5 = statistics.mean(secs[:5]), statistics.mean(secs[-5:])
        out["sec_per_kimg"] = dict(_quartiles(secs), ticks=len(secs), first5=first5, last5=last5,
                                   drift=last5 / first5 - 1)
    out["augment_p"] = dict(min=min(augment), max=max(augment), last=augment[-1]) if augment else None
    out["non_finite"] = bad
    out["kimg"] = out["pieces"][-1]["kimg_last"]
    out["metrics"] = {k: sorted(v) for k, v in out["metrics"].items()}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pieces", nargs="+")
    ap.add_argument("--json", default=None, help="also write the summary here")
    args = ap.parse_args()
    s = summarise(args.pieces)
    sk = s["sec_per_kimg"]
    print(f"kimg: {s['kimg']} over {len(s['pieces'])} pieces; non-finite values: {s['non_finite']}")
    if sk:
        print(f"sec/kimg over {sk['ticks']} ticks (each piece's first left out): median "
              f"{sk['median']:.2f}, quartiles {sk['q1']:.2f} / {sk['q3']:.2f}, min "
              f"{sk['min']:.2f}, max {sk['max']:.2f}; first five {sk['first5']:.2f}, last five "
              f"{sk['last5']:.2f} (drift {sk['drift']:+.1%})")
    for p in s["pieces"]:
        print(f"piece {p['dir']}: ticks {p['ticks']}, kimg {p['kimg_first']} -> {p['kimg_last']}, "
              f"first tick {p['first_tick_sec_per_kimg']:.2f} sec/kimg; device peak GB "
              f"{p['devmem_peak_gb'][0]:.2f} -> {p['devmem_peak_gb'][1]:.2f}, in use "
              f"{p['devmem_gb'][0]:.2f} -> {p['devmem_gb'][1]:.2f}; host RSS GB "
              f"{p['cpumem_gb'][0]:.2f} -> {p['cpumem_gb'][1]:.2f}; launches {p['launches']}")
    if s["augment_p"]:
        print(f"augment_p: min {s['augment_p']['min']}, max {s['augment_p']['max']}, "
              f"last {s['augment_p']['last']}")
    for k, pts in s["metrics"].items():
        print(f"{k}: " + "  ".join(f"{kimg}:{v:.4g}" for kimg, v in pts))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)


if __name__ == "__main__":
    main()
