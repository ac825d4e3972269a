"""Checkpoints: the port's training snapshots, graft, the legacy ``.pkl``
reader and ``generate --ckpt`` in its three forms.

A reference snapshot pickle is a plain ``pickle.dump`` of live torch
modules (reference training_loop.py:396-411). The port's modules carry
the reference's state-dict names, so pickling them the same way gives
such a snapshot without the reference code (``tests/test_legacy_pkl.py``
builds one from the reference's own classes, which this host lacks).
"""

import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from layoutdetr_tpu.utils import checkpoint as jax_ckpt
from layoutdetr_tpu.utils import legacy_pkl as jax_pkl
from layoutdetr_tpu_torch import generate
from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.training.loss import LossWeights
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import GANTrainState, make_g_reg_step, make_train_step
from layoutdetr_tpu_torch.utils import checkpoint as ckpt
from layoutdetr_tpu_torch.utils import legacy_pkl

from test_torch_common import TINY_KW
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_train_step import _batch, _torch

# Every field a reference state dict cannot tell (DETR 6+6, nhead 8, the
# full ResNet50, 4 BERT heads) at its default, so a .pkl of this G loads
# through inference alone; the inferable widths are small.
PKL_CFG = GeneratorConfig(hidden_dim=16, bert_f_dim=32, bert_num_encoder_layers=2,
                          bert_num_decoder_layers=1, im_f_dim=16, max_text_length=16,
                          bert_intermediate_size=64, bert_max_position_embeddings=32)


def _tiny_state(seed):
    cfg = GeneratorConfig(**{**TINY_KW, "vocab_size": 30524, "bos_token_id": 30522,
                             "reconst_decoder_layers": 1, "uncond_encoder_layers": 1})
    torch.manual_seed(seed)
    G, D = Generator(cfg), Discriminator(cfg)
    return GANTrainState.create(G.train(), D.train(), build_optimizer(G, reg_interval=4),
                                build_optimizer(D, reg_interval=16))


def _assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_snapshot_round_trip_is_bit_exact(tmp_path):
    state = _tiny_state(0)
    batch = _torch(_batch())
    gen = torch.Generator().manual_seed(0)
    make_train_step(batch_size=2, z_dim=4, max_elements=9)(state, batch, gen)
    make_g_reg_step(LossWeights(pl_weight=2.0), z_dim=4, max_elements=9)(state, batch, gen)
    assert float(state.pl_mean) > 0 and state.opt_g.state and state.opt_d.state
    path = str(tmp_path / "network-snapshot-000000.pt")
    ckpt.save_checkpoint(path, state)
    assert not os.path.exists(path + ".tmp")

    other = _tiny_state(1)
    assert not torch.equal(other.G.fc_z.weight, state.G.fc_z.weight)
    ckpt.restore_checkpoint(path, other)
    _assert_same(ckpt.snapshot_of(other), ckpt.snapshot_of(state), "state")
    assert other.step == 1 and other.pl_mean.dtype == torch.float32
    with pytest.raises(ValueError, match="not a training snapshot"):
        torch.save({"G": {}}, str(tmp_path / "bad.pt"))
        ckpt.load_snapshot(str(tmp_path / "bad.pt"))


def test_graft_behaves_as_jax():
    params = {"a": {"w": np.zeros((2, 3), np.float32)}, "b": np.ones(2, np.float32)}
    flat = {"a.w": torch.zeros(2, 3), "b": torch.ones(2)}
    # overlay where present, keep the init elsewhere, skip unknown keys
    want = jax_ckpt.graft(params, {"a": {"w": np.full((2, 3), 5.0, np.float32)}, "c": np.ones(1)})
    got = ckpt.graft(flat, {"a.w": torch.full((2, 3), 5.0), "c": torch.ones(1)})
    np.testing.assert_array_equal(got["a.w"].numpy(), want["a"]["w"])
    np.testing.assert_array_equal(got["b"].numpy(), want["b"])
    assert "c" not in got
    # a shape mismatch raises on both sides
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_ckpt.graft(params, {"a": {"w": np.zeros((3, 3), np.float32)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.graft(flat, {"a.w": torch.zeros(3, 3)})


@pytest.fixture(scope="module")
def pkl_snapshot():
    torch.manual_seed(3)
    G = Generator(PKL_CFG).eval()
    D = Discriminator(GeneratorConfig(**{**TINY_KW, "reconst_decoder_layers": 1,
                                         "uncond_encoder_layers": 1}))
    blob = pickle.dumps(dict(G=G, D=D, G_ema=G, augment_pipe=None,
                             training_set_kwargs={"path": "train.zip", "max_elements": 9}))
    return G, D, blob


def test_load_network_pkl_matches_jax(pkl_snapshot):
    G, D, blob = pkl_snapshot
    got, want = legacy_pkl.load_network_pkl(blob), jax_pkl.load_network_pkl(blob)
    assert set(got) == set(want) == {"G", "D", "G_ema", "augment_pipe", "training_set_kwargs"}
    assert got["augment_pipe"] is None and got["training_set_kwargs"]["max_elements"] == 9
    for key, module in (("G", G), ("D", D), ("G_ema", G)):
        sd = {k: v.numpy() for k, v in module.state_dict().items()}
        assert set(got[key]["state_dict"]) == set(want[key]["state_dict"]) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[key]["state_dict"][k], v, err_msg=k)
            np.testing.assert_array_equal(want[key]["state_dict"][k], v, err_msg=k)
    assert legacy_pkl.infer_generator_config(got["G"]["state_dict"]) == \
        jax_pkl.infer_generator_config(got["G"]["state_dict"])


def test_unknown_globals_never_execute(tmp_path):
    """A hostile reduce comes back as an inert stub (JAX test's case)."""
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    data = legacy_pkl.SafeUnpickler(io.BytesIO(pickle.dumps({"G": Evil()}))).load()
    assert isinstance(data["G"], legacy_pkl._Stub)
    assert type(data["G"])._stub_origin[1] == "system"
    assert not marker.exists()


def test_nested_storage_blob_never_executes(tmp_path):
    """A code pickle nested in a storage blob is refused (JAX test's case)."""
    import torch.storage

    marker = tmp_path / "pwned"

    class EvilStorage:
        def __reduce__(self):
            inner = pickle.dumps((os.system, (f"touch {marker}",)))
            return (torch.storage._load_from_bytes, (inner,))

    with pytest.raises(pickle.UnpicklingError):
        legacy_pkl.SafeUnpickler(io.BytesIO(pickle.dumps({"G": EvilStorage()}))).load()
    assert not marker.exists()


def test_generate_ckpt_takes_all_three_forms(pkl_snapshot, tmp_path, monkeypatch):
    """One G as a save_generator file, a training snapshot (its G_ema) and a
    reference .pkl: ``generate --ckpt`` serves the same layout from each."""
    import PIL.Image

    G, D, blob = pkl_snapshot
    # a .pkl carries WordPiece-trained BERT: the CLI then needs a vocab
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    (vocab / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "big", "sale", "shop", "now"]) + "\n")
    monkeypatch.setenv("LAYOUTDETR_BERT_VOCAB", str(vocab))

    forms = {}
    forms["generator"] = str(tmp_path / "g.pt")
    generate.save_generator(G, forms["generator"])
    state = GANTrainState.create(G, D, build_optimizer(G), build_optimizer(D))
    forms["snapshot"] = str(tmp_path / "network-snapshot-000000.pt")
    ckpt.save_checkpoint(forms["snapshot"], state)
    ckpt.write_gcfg(forms["snapshot"], PKL_CFG)
    forms["pkl"] = str(tmp_path / "snapshot.pkl")
    with open(forms["pkl"], "wb") as f:
        f.write(blob)

    bg = str(tmp_path / "bg.png")
    PIL.Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 80, 3), np.uint8)).save(bg)
    results = {}
    for name, path in forms.items():
        model = ckpt.load_generator_checkpoint(path, device="cpu")
        assert model.cfg == PKL_CFG, name
        for k, v in G.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), (name, k)
        (layout,) = generate.main(["--ckpt", path, "--bg", bg, "--strings", "big sale|shop now",
                                   "--string-labels", "header|button", "--device", "cpu",
                                   "--outfile", str(tmp_path / name / "out")])
        with open(tmp_path / name / "out.json") as f:
            assert len(json.load(f)["bbox_xcycwh"]) == 2
        assert os.path.exists(tmp_path / name / "out_bboxes.png")
        results[name] = layout.raw
    np.testing.assert_array_equal(results["generator"], results["snapshot"])
    np.testing.assert_array_equal(results["generator"], results["pkl"])
