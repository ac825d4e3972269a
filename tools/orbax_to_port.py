#!/usr/bin/env python
"""Convert a JAX (orbax) checkpoint into a file the PyTorch port reads.

    python tools/orbax_to_port.py --src RUN/network-snapshot-000100 --dest snap.pt
    python tools/orbax_to_port.py --src RUN/network-snapshot-000100 --dest g.pt --generator-only
    python tools/orbax_to_port.py --kind layoutnet --src layoutnet_ckpt --dest layoutnet.pt
    python tools/orbax_to_port.py --kind inception --src inception_ckpt --dest pt_inception.pt

It runs where the JAX package and orbax are installed (the port's own
machine needs neither); copy the file it writes over. It restores the
directory with ``layoutdetr_tpu.utils.checkpoint.restore_checkpoint``
(no target: optax's states come back as plain containers) and writes:

1. from a train-state directory (the JAX trainer's
   ``network-snapshot-*``): a port training snapshot (``torch.save``) and
   ``<dest>.gcfg.json`` from ``<src>.gcfg.json``, which ``python -m
   layoutdetr_tpu_torch.train --resume <dest>`` continues: G, D and G_ema,
   both Adam states (``utils.convert.snapshot_from_jax``), ``step`` and
   ``pl_mean``. The Adam hyperparameters are the run's ``glr``/``dlr``
   from ``training_options.json`` beside the snapshot, where it is, else
   the trainer's defaults;
2. with ``--generator-only``, from a train-state directory (its
   ``params_gema``) or a bare Generator params directory: a
   ``generate.save_generator`` file and its ``<dest>.json`` config, which
   ``generate --ckpt``, ``evaluate --ckpt`` and the server read; the
   config is what the JAX package's ``load_generator_checkpoint`` makes of
   the directory;
3. with ``--kind layoutnet`` or ``--kind inception``, from
   ``utils/torch_convert.py``'s orbax output: the state dict that the
   port's ``--layoutnet-ckpt`` / ``--inception-ckpt`` read.

``<src>.converted.json`` (weights converted from torch, whose BERT takes
real WordPiece ids) is copied to ``<dest>.converted.json``, so the port's
tokenizer guard keeps refusing them with its hash tokenizer.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
from typing import Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from layoutdetr_tpu.utils.checkpoint import load_generator_checkpoint, restore_checkpoint  # noqa: E402
from layoutdetr_tpu_torch.config import GeneratorConfig  # noqa: E402
from layoutdetr_tpu_torch.utils import convert  # noqa: E402
from layoutdetr_tpu_torch.utils.checkpoint import write_gcfg  # noqa: E402


def _gcfg(src: str) -> GeneratorConfig:
    path = src + ".gcfg.json"
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} is missing: the JAX trainer writes it beside each snapshot")
    with open(path) as f:
        return GeneratorConfig.from_dict(json.load(f))


def _learning_rates(src: str) -> dict:
    path = os.path.join(os.path.dirname(os.path.abspath(src)), "training_options.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        opts = json.load(f)
    return {k: float(opts[k]) for k in ("glr", "dlr") if k in opts}


def _num_layers(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def convert_checkpoint(src: str, dest: str, kind: str = "gan",
                       generator_only: bool = False) -> str:
    """Write the port's file for the orbax checkpoint ``src`` at ``dest``;
    returns what was written."""
    src = src.rstrip("/")
    if kind in ("layoutnet", "inception"):
        tree = restore_checkpoint(src)
        tree = tree.get("params", tree)
        if kind == "layoutnet":
            sd = convert.layoutnet_state_dict_from_jax(
                tree, num_layers=_num_layers(tree["enc_transformer"], "layers_"))
        else:
            sd = convert.inception_state_dict_from_jax(tree)
        torch.save(sd, dest)
        what = f"{kind} state dict ({len(sd)} tensors)"
    elif generator_only:
        from layoutdetr_tpu_torch.generate import save_generator
        from layoutdetr_tpu_torch.models.generator import Generator

        params, jcfg = load_generator_checkpoint(src)
        cfg = GeneratorConfig.from_dict(dataclasses.asdict(jcfg))
        model = Generator(cfg)
        model.load_state_dict(convert.generator_state_dict_from_jax(params, cfg), strict=True)
        save_generator(model, dest)
        what = "save_generator file and its .json"
    else:
        state = restore_checkpoint(src)
        if not isinstance(state, dict) or "opt_state_g" not in state:
            raise ValueError(f"{src} holds no training state (no opt_state_g); pass "
                             "--generator-only for a bare Generator params directory")
        cfg = _gcfg(src)
        snap = convert.snapshot_from_jax(state, cfg, **_learning_rates(src))
        torch.save(snap, dest)
        write_gcfg(dest, cfg)
        what = f"training snapshot (step {snap['step']}) and its .gcfg.json"
    if os.path.isfile(src + ".converted.json"):
        shutil.copyfile(src + ".converted.json", dest + ".converted.json")
        what += ", .converted.json"
    return what


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="orbax checkpoint directory")
    ap.add_argument("--dest", required=True, help="file to write")
    ap.add_argument("--kind", default="gan", choices=["gan", "layoutnet", "inception"],
                    help="gan: a JAX trainer's snapshot or Generator params (default); "
                         "layoutnet / inception: torch_convert's orbax output")
    ap.add_argument("--generator-only", action="store_true",
                    help="write the Generator alone (G_ema of a training state, or bare "
                         "params) as a save_generator file")
    opts = ap.parse_args(argv)
    if opts.generator_only and opts.kind != "gan":
        ap.error("--generator-only goes with --kind gan")
    what = convert_checkpoint(opts.src, opts.dest, opts.kind, opts.generator_only)
    print(f"{opts.src} -> {opts.dest}: {what}")
    return what


if __name__ == "__main__":
    main()
