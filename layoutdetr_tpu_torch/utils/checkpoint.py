"""Training snapshots, cold-start grafts and the generator checkpoint reader.

Counterpart of ``layoutdetr_tpu/utils/checkpoint.py``. A snapshot is one
``torch.save`` file holding what JAX's orbax snapshot holds of the
``GANTrainState``: the state dicts of G, D and G_ema, both Adam states,
``step`` and ``pl_mean``. The training loop writes the model config
beside it as ``<snapshot>.gcfg.json``. Files are read with
``weights_only=True``: loading runs no pickled code.

A snapshot also comes from a JAX run: ``tools/orbax_to_port.py`` turns
the JAX trainer's orbax snapshot into one (``utils.convert.snapshot_from_jax``:
weights, Adam moments, ``step`` and ``pl_mean``), which ``restore_checkpoint``
loads strictly and ``train --resume`` continues.

Several ranks (``parallel.distributed``): rank 0 writes the snapshot. A
snapshot of a tensor-parallel state holds the full tensors, gathered over
the model group (every rank takes part), so it loads into any layout and
into ``generate`` / ``evaluate``; a restore into a sharded state loads
each rank's slices.

``load_generator_checkpoint`` reads the three forms a ``--ckpt`` may
take: a training snapshot (its G_ema), a ``generate.save_generator`` file
(``<ckpt>.json`` beside it) and a reference ``.pkl`` snapshot (through the
restricted unpickler of ``utils.legacy_pkl``; the port's modules keep the
reference's state-dict names, so it loads as it is).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Union

import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.parallel import tensor_parallel as tp

SNAPSHOT_KEYS = ("G", "D", "G_ema", "opt_g", "opt_d", "step", "pl_mean")


def snapshot_of(state) -> dict:
    """The snapshot dict of a ``GANTrainState``: tensors as they are, or,
    for a tensor-parallel state, the full tensors (collective over the
    model group)."""
    shard = tp.model_shard()
    snap = dict(G=state.G.state_dict(), D=state.D.state_dict(), G_ema=state.G_ema.state_dict(),
                opt_g=state.opt_g.state_dict(), opt_d=state.opt_d.state_dict(),
                step=int(state.step), pl_mean=state.pl_mean)
    if shard is None:
        return snap
    group = distributed.grid().tp_group
    for key in ("G", "D", "G_ema"):
        snap[key] = tp.gather_state_dict(snap[key], *shard, group)
    for key, module in (("opt_g", state.G), ("opt_d", state.D)):
        snap[key] = tp.gather_optimizer_state_dict(snap[key], tp.trainable_names(module), *shard,
                                                   group)
    return snap


def save_checkpoint(path: str, state) -> None:
    """Write ``state``'s snapshot to ``path`` (through a temporary file, so a
    reader never sees half a snapshot); with several ranks every rank
    calls it and rank 0 writes."""
    snap = snapshot_of(state)
    g = distributed.grid()
    if g is None or g.is_chief:
        tmp = path + ".tmp"
        torch.save(snap, tmp)
        os.replace(tmp, path)
    if g is not None:  # a barrier: no rank reads the path before it is written
        distributed.all_reduce_host([0.0])


def load_snapshot(path: str) -> dict:
    """A snapshot file, on the CPU."""
    snap = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(snap, dict) or set(SNAPSHOT_KEYS) - set(snap):
        raise ValueError(f"{path} is not a training snapshot (keys {SNAPSHOT_KEYS})")
    return snap


def restore_checkpoint(path: str, state):
    """Load the snapshot at ``path`` into ``state`` (modules, optimizers,
    step and pl_mean, on their devices; a tensor-parallel state takes its
    rank's slices); returns ``state``."""
    snap = load_snapshot(path)
    shard = tp.model_shard()
    if shard is not None:
        for key in ("G", "D", "G_ema"):
            snap[key] = tp.shard_state_dict(snap[key], *shard)
        for key, module in (("opt_g", state.G), ("opt_d", state.D)):
            snap[key] = tp.shard_optimizer_state_dict(snap[key], tp.trainable_names(module),
                                                      *shard)
    for key in ("G", "D", "G_ema"):
        getattr(state, key).load_state_dict(snap[key], strict=True)
    state.opt_g.load_state_dict(snap["opt_g"])
    state.opt_d.load_state_dict(snap["opt_d"])
    state.step = int(snap["step"])
    state.pl_mean = snap["pl_mean"].to(state.pl_mean.device)
    return state


def load_state_dict_file(path: str, key: str) -> Dict[str, torch.Tensor]:
    """The state dict of module ``key`` ("G", "D" or "G_ema") in ``path``:
    a training snapshot or reference ``.pkl`` (its entry ``key``), or a
    file that holds one state dict."""
    if path.endswith(".pkl"):
        from layoutdetr_tpu_torch.utils.legacy_pkl import load_network_pkl

        entry = load_network_pkl(path).get(key)
        if entry is None:
            raise ValueError(f"{path} holds no {key} module")
        return {k: torch.from_numpy(v) for k, v in entry["state_dict"].items()}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj[key] if key in obj and isinstance(obj[key], dict) else obj


def graft(params: Dict[str, torch.Tensor], pretrained: Dict[str, torch.Tensor]) -> dict:
    """Overlay ``pretrained`` onto the state dict ``params``, keeping the
    init values of everything ``pretrained`` lacks: the reference's
    strict=False cold-start load (training_loop.py:138-140). An entry in
    both must agree in shape (ValueError otherwise); entries ``params``
    lacks are reported and skipped."""
    out = dict(params)
    for k, v in pretrained.items():
        if k not in out:
            print(f"(graft: skipping unknown key {k})")
            continue
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"graft shape mismatch at {k}: {tuple(out[k].shape)} vs {tuple(v.shape)}")
        out[k] = v
    return out


def load_generator_checkpoint(ckpt: str, device: Union[str, torch.device] = "cuda",
                              dtype: torch.dtype = torch.float32, **gcfg_defaults):
    """A ``--ckpt`` -> the Generator in eval mode on ``device``:

    - ``*.pkl``: a reference snapshot; G_ema (else G), its config inferred
      from the weights' shapes over ``gcfg_defaults``;
    - a training snapshot: its G_ema, config from ``<ckpt>.gcfg.json``;
    - a ``save_generator`` file: config from ``<ckpt>.json``."""
    if ckpt.endswith(".pkl"):
        from layoutdetr_tpu_torch.utils.legacy_pkl import load_network_pkl

        return generator_from_network_pkl(load_network_pkl(ckpt), device, dtype, ckpt,
                                          **gcfg_defaults)
    obj = torch.load(ckpt, map_location="cpu", weights_only=True)
    snapshot = "G_ema" in obj and isinstance(obj["G_ema"], dict)
    sd = obj["G_ema"] if snapshot else obj
    with open(ckpt + (".gcfg.json" if snapshot else ".json")) as f:
        fields = dict(gcfg_defaults, **json.load(f))
    return _generator(fields, sd, device, dtype)


def generator_from_network_pkl(nets: dict, device: Union[str, torch.device] = "cuda",
                               dtype: torch.dtype = torch.float32, name: str = "the snapshot",
                               **gcfg_defaults):
    """The Generator of a reference snapshot that ``legacy_pkl.load_network_pkl``
    read: G_ema (else G), its config inferred from the weights' shapes over
    ``gcfg_defaults``, in eval mode on ``device``."""
    from layoutdetr_tpu_torch.utils.legacy_pkl import infer_generator_config

    entry = nets.get("G_ema") or nets.get("G")
    if entry is None:
        raise ValueError(f"{name} contains no G_ema/G module")
    fields = dict(gcfg_defaults, **infer_generator_config(entry["state_dict"]))
    return _generator(fields, {k: torch.from_numpy(v) for k, v in entry["state_dict"].items()},
                      device, dtype)


def _generator(fields: dict, sd: Dict[str, torch.Tensor], device, dtype):
    from layoutdetr_tpu_torch.models.generator import Generator

    model = Generator(GeneratorConfig.from_dict(fields), dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def write_gcfg(snapshot_path: str, cfg: GeneratorConfig) -> None:
    """The config sidecar ``<snapshot>.gcfg.json`` (train_loop.py:629-630)."""
    with open(snapshot_path + ".gcfg.json", "w") as f:
        json.dump(cfg.to_dict(), f)
