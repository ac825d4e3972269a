"""Safe reader for reference LayoutDETR / StyleGAN snapshot pickles.

A copy of ``layoutdetr_tpu/utils/legacy_pkl.py``, so that the port
imports nothing of the JAX package. The port's modules keep the
reference's ``networks_detr`` state-dict names, so a state dict read here
loads into them by ``load_state_dict`` (``utils.checkpoint``), with no
converter. Paths, file objects and bytes are read; URLs are not.

The reference saves training snapshots with plain ``pickle.dump`` of live
torch modules (training_loop.py:396-411: ``dict(G=..., D=..., G_ema=...,
augment_pipe=..., training_set_kwargs=...)``) and loads them with
``legacy.load_network_pkl`` (legacy.py:23-59), which requires every
module class to be importable — ``training.networks_detr`` by module
path, and the StyleGAN2 submodules through
``torch_utils.persistence._reconstruct_persistent_obj``
(persistence.py:114-199), which EXECUTES Python source embedded in the
pickle.

This reader recovers the released checkpoints WITHOUT the reference
environment and WITHOUT executing embedded source: a restricted
unpickler resolves only tensor-reconstruction primitives to real
callables and replaces every other global — module classes,
``_reconstruct_persistent_obj``, tokenizers — with inert stubs that
capture the object state. The torch module tree is then walked exactly
the way ``nn.Module.state_dict()`` walks it (``_parameters`` /
persistent ``_buffers`` / ``_modules`` recursion), yielding the same
flat ``name -> array`` mapping the live module would produce.

Security note: this is deliberately stricter than the reference loader.
``legacy.py`` will run arbitrary embedded source; here an unknown global
never executes (stub classes have no behavior), and only torch's own
storage/tensor rebuild helpers are invoked.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Restricted unpickling


class _Stub:
    """Inert stand-in for any class the allowlist does not cover.

    Supports every flavor of state the pickle protocol can hand a class
    instance: REDUCE/NEWOBJ construction args, ``__setstate__`` dicts,
    dict items (dict subclasses like dnnlib.EasyDict), and list items.
    """

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            # protocol-2 (dict_state, slots_state) pairs
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self.__dict__["_stub_state"] = state

    # dict-subclass / list-subclass protocols
    def __setitem__(self, k, v):
        self.__dict__.setdefault("_stub_items", {})[k] = v

    def append(self, v):
        self.__dict__.setdefault("_stub_list", []).append(v)

    def extend(self, vs):
        self.__dict__.setdefault("_stub_list", []).extend(vs)


_STUB_CLASS_CACHE: Dict[tuple, type] = {}


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    cls = _STUB_CLASS_CACHE.get(key)
    if cls is None:
        cls = type(name, (_Stub,), {"_stub_origin": key})
        _STUB_CLASS_CACHE[key] = cls
    return cls


def _reconstruct_persistent_stub(meta: dict) -> _Stub:
    """Replacement for persistence._reconstruct_persistent_obj: keep the
    captured module state (``meta['state']`` is the module __dict__,
    persistence.py:114-122) but never touch ``meta['module_src']``."""
    obj = _stub_class("torch_utils.persistence", meta.get("class_name", "Persistent"))()
    state = meta.get("state")
    if isinstance(state, dict):
        obj.__dict__.update(state)
    obj.__dict__["_persistent_meta"] = {
        k: meta.get(k) for k in ("type", "version", "class_name")
    }
    return obj


def _safe_load_storage_from_bytes(b: bytes):
    """Drop-in for ``torch.storage._load_from_bytes`` that never runs an
    unrestricted unpickle.

    torch's own ``_load_from_bytes`` calls ``torch.load(...,
    weights_only=False)`` on attacker-controlled bytes — allowlisting it
    would let a crafted pkl smuggle arbitrary callables inside the
    nested blob. The blob format is torch's *legacy* serialization
    (``__reduce_ex__`` always saves storages with
    ``_use_new_zipfile_serialization=False``): four pickles (magic,
    protocol, sys_info, the storage persistent-id) followed by the key
    list and ``<int64 numel><raw data>`` per key. Parse that directly,
    resolving only ``torch.*Storage`` classes."""
    import struct

    import torch

    f = io.BytesIO(b)

    class _StorageOnlyUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module in ("torch", "torch.storage") and (
                    name.endswith("Storage")):
                attr = getattr(torch, name, None) or getattr(
                    torch.storage, name, None)
                if attr is not None:
                    return attr
            raise pickle.UnpicklingError(
                f"storage blob references non-storage global {module}.{name}")

        def persistent_load(self, pid):
            return pid

    def _read_pickle():
        return _StorageOnlyUnpickler(f).load()

    magic = _read_pickle()
    if magic != 0x1950A86A20F9469CFC6C:  # torch legacy magic number
        raise pickle.UnpicklingError("not a torch legacy storage blob")
    _read_pickle()  # protocol version
    sys_info = _read_pickle()
    if not sys_info.get("little_endian", True):
        raise pickle.UnpicklingError("big-endian storage blobs unsupported")
    pid = _read_pickle()
    if not (isinstance(pid, tuple) and len(pid) >= 5 and pid[0] == "storage"):
        raise pickle.UnpicklingError("unexpected storage persistent id")
    storage_type, numel = pid[1], pid[4]
    keys = _read_pickle()
    if not (isinstance(keys, list) and len(keys) == 1):
        raise pickle.UnpicklingError("expected exactly one storage key")
    (n_elems,) = struct.unpack("<q", f.read(8))
    if storage_type is torch.UntypedStorage:
        dtype, itemsize = torch.uint8, 1
    else:
        import warnings

        with warnings.catch_warnings():
            # legacy typed classes (FloatStorage, ...) warn on access
            warnings.simplefilter("ignore")
            dtype = storage_type.dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
    if n_elems != numel:
        raise pickle.UnpicklingError("storage length mismatch")
    raw = f.read(n_elems * itemsize)
    if len(raw) != n_elems * itemsize:
        raise pickle.UnpicklingError("truncated storage data")
    flat = torch.frombuffer(bytearray(raw), dtype=dtype).clone()
    if storage_type is torch.UntypedStorage:
        return flat.untyped_storage()
    try:
        return torch.storage.TypedStorage(
            wrap_storage=flat.untyped_storage(), dtype=dtype, _internal=True)
    except TypeError:  # older signature without _internal
        return torch.storage.TypedStorage(
            wrap_storage=flat.untyped_storage(), dtype=dtype)


def _torch_allowed(module: str, name: str):
    """Real callables needed to rebuild torch tensors from a plain
    pickle, and nothing else executable."""
    import torch

    if module == "torch._utils" and name.startswith("_rebuild_"):
        return getattr(torch._utils, name)
    if module == "torch.storage" and name == "_load_from_bytes":
        return _safe_load_storage_from_bytes
    if module == "torch.serialization" and name == "_get_layout":
        return torch.serialization._get_layout
    if module == "torch":
        attr = getattr(torch, name, None)
        # dtypes (torch.float32, ...), Size, device, legacy *Storage classes
        if isinstance(attr, torch.dtype) or name in ("Size", "device") \
                or name.endswith("Storage"):
            return attr
    return None


def _numpy_allowed(module: str, name: str):
    if module in ("numpy.core.multiarray", "numpy._core.multiarray") and \
            name in ("_reconstruct", "scalar"):
        import numpy.core.multiarray as m

        return getattr(m, name)
    if module == "numpy" and name in ("ndarray", "dtype", "float32", "float64", "int64"):
        return getattr(np, name)
    if module == "_codecs" and name == "encode":
        import _codecs

        return _codecs.encode
    return None


class SafeUnpickler(pickle.Unpickler):
    """Unpickler that rebuilds tensors for real and stubs everything else."""

    def find_class(self, module: str, name: str):  # noqa: D102
        if module in ("builtins", "__builtin__") and name in ("set", "frozenset"):
            # protocol <=3 pickles emit builtins.set as a GLOBAL opcode
            # (e.g. nn.Module._non_persistent_buffers_set); stubbing it
            # would break `n not in nonpersist` in _walk_module.
            return {"set": set, "frozenset": frozenset}[name]
        if module == "collections":
            import collections

            return getattr(collections, name)
        fn = _torch_allowed(module, name) or _numpy_allowed(module, name)
        if fn is not None:
            return fn
        if name == "_reconstruct_persistent_obj":
            return _reconstruct_persistent_stub
        return _stub_class(module, name)


# ---------------------------------------------------------------------------
# Module-tree walking (mirrors torch.nn.Module.state_dict naming)


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _module_dict(obj) -> Optional[dict]:
    """The captured __dict__ of a (stubbed or real) nn.Module, or None."""
    d = obj if isinstance(obj, dict) else getattr(obj, "__dict__", None)
    if isinstance(d, dict) and ("_parameters" in d or "_buffers" in d or "_modules" in d):
        return d
    return None


def _walk_module(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    d = _module_dict(obj)
    if d is None:
        return
    nonpersist = d.get("_non_persistent_buffers_set") or set()
    for n, t in (d.get("_parameters") or {}).items():
        if t is not None:
            out[prefix + n] = _to_numpy(t)
    for n, t in (d.get("_buffers") or {}).items():
        if t is not None and n not in nonpersist:
            out[prefix + n] = _to_numpy(t)
    for n, m in (d.get("_modules") or {}).items():
        if m is not None:
            _walk_module(m, prefix + n + ".", out)


def state_dict_of(obj) -> Dict[str, np.ndarray]:
    """Flat ``name -> numpy`` state dict of a captured module tree —
    byte-identical keys/values to the live module's ``.state_dict()``."""
    out: Dict[str, np.ndarray] = {}
    _walk_module(obj, "", out)
    return out


def _plain(obj):
    """Stub/EasyDict payloads back to plain python (for kwargs dicts)."""
    if isinstance(obj, _Stub):
        items = obj.__dict__.get("_stub_items")
        if items is not None:
            return {k: _plain(v) for k, v in items.items()}
        lst = obj.__dict__.get("_stub_list")
        if lst is not None:
            return [_plain(v) for v in lst]
        return {k: _plain(v) for k, v in obj.__dict__.items()
                if not k.startswith("_stub")}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


# ---------------------------------------------------------------------------
# Public API


def load_network_pkl(f) -> Dict[str, Any]:
    """Read a reference snapshot pickle (path, file object, or bytes).

    Returns ``{key: {"state_dict": {...}, "init_kwargs": {...}|None,
    "class": "module.Class"}}`` for every module entry (G / D / G_ema /
    augment_pipe), plus ``"training_set_kwargs"`` verbatim. Equivalent
    coverage to legacy.load_network_pkl (legacy.py:23-59) minus the dead
    TF-pickle branch (the released LayoutDETR checkpoints are all
    torch-era pickles).
    """
    if isinstance(f, (bytes, bytearray)):
        f = io.BytesIO(f)
    close = False
    if isinstance(f, str):
        f = open(f, "rb")
        close = True
    try:
        data = SafeUnpickler(f).load()
    finally:
        if close:
            f.close()
    if not isinstance(data, dict):
        raise ValueError(f"unsupported snapshot pickle (top-level {type(data)!r})")

    out: Dict[str, Any] = {}
    for key, value in data.items():
        if key == "training_set_kwargs":
            out[key] = _plain(value)
            continue
        if value is None or _module_dict(value) is None:
            out[key] = None
            continue
        kwargs = getattr(value, "__dict__", {}).get("_init_kwargs")
        origin = getattr(type(value), "_stub_origin", None)
        meta = getattr(value, "__dict__", {}).get("_persistent_meta") or {}
        out[key] = {
            "state_dict": state_dict_of(value),
            "init_kwargs": _plain(kwargs) if kwargs is not None else None,
            "class": meta.get("class_name") or
                     (".".join(origin) if origin else type(value).__name__),
        }
    return out


def infer_bert_layers(sd: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Count BERT encoder/decoder layers from reference state-dict keys
    (networks_detr.py:92-113 layout: ``text_encoder.encoder.layer.N.``,
    ``text_decoder.bert.encoder.layer.N.``)."""
    def _count(prefix: str) -> int:
        idx = set()
        for k in sd:
            if k.startswith(prefix):
                rest = k[len(prefix):]
                head = rest.split(".", 1)[0]
                if head.isdigit():
                    idx.add(int(head))
        return (max(idx) + 1) if idx else 0

    enc = _count("text_encoder.encoder.layer.")
    dec = _count("text_decoder.bert.encoder.layer.")
    vocab = 0
    for k in ("text_encoder.embeddings.word_embeddings.weight",
              "text_decoder.bert.embeddings.word_embeddings.weight"):
        if k in sd:
            vocab = int(sd[k].shape[0])
            break
    return {"bert_encoder_layers": enc, "bert_decoder_layers": dec,
            "vocab_size": vocab}


def infer_generator_config(sd: Dict[str, np.ndarray]) -> Dict[str, int]:
    """GeneratorConfig kwargs recoverable from a reference Generator
    state dict's shapes (networks_detr.py:66-131 layout).

    Not inferable from weights (caller keeps defaults / CLI overrides):
    ``bert_num_heads`` (reference train.py CLI default 4),
    ``background_size`` (runtime input resolution only), and the DETR
    transformer dims (hardcoded 6+6 / nhead 8 / ffn 2048 in the
    reference, networks_detr.py:99-108 — already our defaults).
    """
    out: Dict[str, int] = {}
    layers = infer_bert_layers(sd)
    if layers["bert_encoder_layers"]:
        out["bert_num_encoder_layers"] = layers["bert_encoder_layers"]
    if layers["bert_decoder_layers"]:
        out["bert_num_decoder_layers"] = layers["bert_decoder_layers"]
    if layers["vocab_size"]:
        out["vocab_size"] = layers["vocab_size"]
        out["bos_token_id"] = layers["vocab_size"] - 2  # resize adds [DEC],[ENC]

    def shape(k):
        t = sd.get(k)
        return tuple(t.shape) if t is not None else None

    s = shape("fc_z.weight")            # (bert_f_dim, z_dim*9)
    if s:
        out["bert_f_dim"], out["z_dim"] = s[0], s[1] // 9
    s = shape("emb_label.weight")       # (num_bbox_labels, bert_f_dim)
    if s:
        out["num_bbox_labels"] = s[0]
    s = shape("enc_text_len.weight")    # (max_text_length, bert_f_dim)
    if s:
        # The reference ties T and the char-length table to the same
        # max_text_length (networks_detr.py:103); our config decouples
        # them (GeneratorConfig.text_len_table) — set both.
        out["max_text_length"] = s[0]
        out["text_len_table"] = s[0]
    s = shape("fc_text_len_rec.weight")  # (max_text_length, hidden_dim)
    if s:
        out["hidden_dim"] = s[1]
    s = shape("text_encoder.embeddings.position_embeddings.weight")
    if s:
        out["bert_max_position_embeddings"] = s[0]
    s = shape("text_encoder.encoder.layer.0.intermediate.dense.weight")
    if s:
        out["bert_intermediate_size"] = s[0]
    s = shape("text_decoder.bert.encoder.layer.0.crossattention.self.key.weight")
    if s:                               # (bert_f_dim, im_f_dim=encoder_width)
        out["im_f_dim"] = s[1]
    return out
