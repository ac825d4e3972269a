"""Where the host loader's time goes with ``--load-patches``: one JSON line.

Times, on the host clock, what a training step waits on when the port's
``PrefetchLoader`` feeds it from a dataset-tool zip with every patch
decoded:

- ``collate_s``: one batch decoded and collated in this process (a
  worker's work per batch), and the batch's bytes with and without its
  ``patches_orig``;
- ``pickle_s`` / ``unpickle_s``: that batch through ``pickle`` (what the
  worker's queue and the parent do to it when it is shipped);
- per mode, ``ship`` (the batch whole) and ``drop`` (``patches_orig`` left
  in the worker, as ``training_loop`` asks): the parent's wait for the
  first batch and for each later one (``next_s``);
- ``to_device_s``: the parent's copy of a dropped batch to the card,
  synchronised (null without a card).

Usage:
  python3 tools/loader_profile_torch.py --data train.zip [--batch 16]
      [--workers 8] [--batches 3] [--modes ship,drop]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from layoutdetr_tpu_torch.data.dataset import (  # noqa: E402
    InfiniteSampler,
    LayoutDataset,
    PrefetchLoader,
    to_device,
)


def nbytes(batch: dict) -> int:
    return sum(v.nbytes for v in batch.values())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batches", type=int, default=3, help="timed batches after the first")
    ap.add_argument("--modes", default="ship,drop")
    args = ap.parse_args(argv)

    ds = LayoutDataset(args.data, cache=False, load_patches=True)
    idx = list(range(args.batch))
    t0 = time.perf_counter()
    batch = ds.collate(idx)
    out = dict(data=args.data, batch=args.batch, workers=args.workers,
               collate_s=time.perf_counter() - t0, batch_bytes=nbytes(batch))
    t0 = time.perf_counter()
    blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
    out["pickle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pickle.loads(blob)
    out["unpickle_s"] = time.perf_counter() - t0
    del blob
    batch.pop("patches_orig")
    out["dropped_batch_bytes"] = nbytes(batch)
    out["to_device_s"] = None
    if torch.cuda.is_available():
        to_device(batch, "cuda")  # the first copy pays the allocator's start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(batch, "cuda")
        torch.cuda.synchronize()
        out["to_device_s"] = time.perf_counter() - t0
    del batch

    for mode in args.modes.split(","):
        drop = ("patches_orig",) if mode == "drop" else ()
        loader = PrefetchLoader(ds, args.batch, InfiniteSampler(len(ds)),
                                num_workers=args.workers, drop=drop)
        try:
            t0 = time.perf_counter()
            next(loader)
            first = time.perf_counter() - t0
            times = []
            for _ in range(args.batches):
                t0 = time.perf_counter()
                next(loader)
                times.append(time.perf_counter() - t0)
        finally:
            loader.close()
        out[mode] = dict(first_s=first, next_s=times)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
