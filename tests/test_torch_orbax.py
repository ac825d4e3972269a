"""JAX (orbax) checkpoints into the port: ``tools/orbax_to_port.py`` over
``utils.convert.snapshot_from_jax``.

A JAX ``GANTrainState`` at tiny dims takes one real optax update (seeded
gradients: non-zero moments, count 1), is saved with JAX's
``save_checkpoint`` and converted by the tool. Bars: the port's
``restore_checkpoint`` takes it strictly; weights equal the converters'
bit for bit; the Adam states hold exactly the entries (keys and shapes)
of a port snapshot after one port step; one more update from the same
gradients agrees with optax to 1e-6 of each tensor's max |value|; G_ema's
boxes match JAX's ``load_generator_checkpoint`` to 1e-5.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax

from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.models.layoutnet import LayoutNet as JaxLayoutNet
from layoutdetr_tpu.utils import checkpoint as jax_ckpt
from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.data.tokenizer import LayoutTokenizer
from layoutdetr_tpu_torch.evaluate import load_layoutnet_state_dict
from layoutdetr_tpu_torch.models.inception import load_inception_params
from layoutdetr_tpu_torch.models.layoutnet import LayoutNet
from layoutdetr_tpu_torch.training import train_loop
from layoutdetr_tpu_torch.training.train_step import make_train_step
from layoutdetr_tpu_torch.utils import checkpoint as ckpt
from layoutdetr_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    inception_state_dict_from_jax,
    layoutnet_state_dict_from_jax,
)

from test_torch_common import REPO_ROOT, random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_generator import _batch as generator_batch
from test_torch_inception import inception_params
from test_torch_train_step import B, N, _batch, _model_kwargs, _torch
from test_torch_vit import VIT_CFG, narrow_vit  # noqa: F401 (fixture)

sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
import orbax_to_port  # noqa: E402

from _torch_full_dims_driver import (  # noqa: E402
    DLR,
    GLR,
    PL_MEAN,
    jax_train_state,
    port_train_state,
    save_jax_run,
    seeded_grads,
)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_state(jcfg, seed=0):
    """A JAX GANTrainState after one optax update of G and D from seeded
    gradients; G_ema keeps the initial G."""
    batch = _batch()
    kw = _model_kwargs(batch)
    pg = random_params(JaxGenerator(jcfg), z=np.zeros((B, N, 4), np.float32),
                       bbox_real=batch["bboxes"], reconst=True, **kw, seed=seed)
    pd = random_params(JaxDiscriminator(jcfg), bbox=batch["bboxes"], reconst=True, **kw,
                       seed=seed + 1)
    return jax_train_state(pg, pd)


def _save(state, jcfg, run_dir):
    """The JAX trainer's files: the orbax snapshot, its .gcfg.json and the
    run's training_options.json."""
    return save_jax_run(state, jcfg, run_dir, batch_size=B)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    # the full vocab: the loader's tokenizer emits real BERT-range ids
    jcfg, cfg = tiny_configs(vocab_size=30524, bos_token_id=30522, reconst_decoder_layers=1,
                             uncond_encoder_layers=1)
    state, tx_g, tx_d = _jax_state(jcfg)
    tmp = tmp_path_factory.mktemp("orbax")
    src = _save(state, jcfg, str(tmp / "run"))
    dest = str(tmp / "snapshot.pt")
    what = orbax_to_port.main(["--src", src, "--dest", dest])
    assert "training snapshot (step 1)" in what
    return dict(jcfg=jcfg, cfg=cfg, state=state, tx=(tx_g, tx_d), src=src, dest=dest, tmp=tmp)


def _assert_state_dict_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), f"{what} {k}"


def test_train_state_restores_strictly_into_the_port(converted):
    c = converted
    pstate = ckpt.restore_checkpoint(c["dest"], port_train_state(c["cfg"]))
    np_state = _np(c["state"])
    for key, sd_fn, params in (("G", generator_state_dict_from_jax, np_state.params_g),
                               ("D", discriminator_state_dict_from_jax, np_state.params_d),
                               ("G_ema", generator_state_dict_from_jax, np_state.params_gema)):
        _assert_state_dict_equal(getattr(pstate, key).state_dict(), sd_fn(params, c["cfg"]), key)
    assert not torch.equal(pstate.G.fc_z.weight, pstate.G_ema.fc_z.weight)
    assert pstate.step == 1 and pstate.pl_mean.dtype == torch.float32
    assert float(pstate.pl_mean) == PL_MEAN
    with open(c["dest"] + ".gcfg.json") as f:
        assert GeneratorConfig.from_dict(json.load(f)) == c["cfg"]

    # a port snapshot after one port step holds the same Adam entries
    stepped = port_train_state(c["cfg"])
    make_train_step(batch_size=B, z_dim=4, max_elements=N, deterministic=True)(
        stepped, _torch(_batch()), torch.Generator().manual_seed(0))
    want = ckpt.snapshot_of(stepped)
    got = ckpt.load_snapshot(c["dest"])
    assert set(got) == set(want) == set(ckpt.SNAPSHOT_KEYS)
    for key in ("opt_g", "opt_d"):
        assert got[key]["param_groups"] == want[key]["param_groups"], key
        assert got[key]["state"].keys() == want[key]["state"].keys(), key
        for i, entry in want[key]["state"].items():
            mine = got[key]["state"][i]
            assert mine.keys() == entry.keys(), (key, i)
            for k, v in entry.items():
                assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, (key, i, k)
            assert float(mine["step"]) == 1.0 and mine["exp_avg_sq"].abs().max() > 0, (key, i)


@pytest.mark.parametrize("module", ["G", "D"])
def test_next_update_agrees_with_optax(converted, module):
    """One more update from the same gradients: optax on the JAX state, the
    port's Adam on the restored snapshot."""
    c = converted
    state, cfg = c["state"], c["cfg"]
    tx = c["tx"][module == "D"]
    params = state.params_g if module == "G" else state.params_d
    opt_state = state.opt_state_g if module == "G" else state.opt_state_d
    to_sd = generator_state_dict_from_jax if module == "G" else discriminator_state_dict_from_jax
    grads = seeded_grads(params, 21)
    updates, _ = jax.jit(tx.update)(grads, opt_state, params)
    want = to_sd(_np(optax.apply_updates(params, updates)), cfg)

    pstate = ckpt.restore_checkpoint(c["dest"], port_train_state(cfg))
    model, opt = (pstate.G, pstate.opt_g) if module == "G" else (pstate.D, pstate.opt_d)
    port_grads = to_sd(_np(grads), cfg)
    n_stepped = 0
    for name, p in model.named_parameters():
        if p in opt.state:  # a JAX leaf's parameter (not a filled crossattention block)
            p.grad = port_grads[name]
            n_stepped += 1
    assert n_stepped > 50
    opt.step()
    got = model.state_dict()
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-6 * max(float(w.abs().max()), 1e-30), f"{module} {name}: {err:.3e}"


def test_train_resumes_from_the_converted_snapshot(converted, tmp_path):
    """The port's training loop (what ``train --resume`` runs) continues the
    JAX run: restored at step 1, one more step through the host loader."""
    c = converted
    data = make_synthetic_zip(str(tmp_path / "train.zip"), num_samples=4, image_size=32,
                              max_elements=9, seed=0, structured=True)
    state = train_loop.training_loop(
        run_dir=str(tmp_path / "run"), data=data, gcfg=c["cfg"], batch_size=2, glr=GLR, dlr=DLR,
        kimg_per_tick=1, network_snapshot_ticks=None, image_snapshot_ticks=None,
        resume=c["dest"], max_steps=1, device="cpu", device_feed="off", num_workers=0,
        module_summary=False)
    assert state.step == 2
    assert {float(e["step"]) for e in state.opt_g.state.values()} == {2.0}
    assert state.opt_g.param_groups[0]["lr"] == pytest.approx(GLR * 4 / 5)


def _jax_boxes(src, batch):
    params, jcfg = jax_ckpt.load_generator_checkpoint(src)
    return np.asarray(jax.jit(JaxGenerator(jcfg).apply)(params, **batch))


def test_generator_boxes_match_jax(converted, tmp_path):
    """G_ema through the port's checkpoint reader, from the converted
    snapshot and from the --generator-only file, against JAX's reader."""
    c = converted
    batch = generator_batch(c["jcfg"])
    want = _jax_boxes(c["src"], batch)
    gema = generator_state_dict_from_jax(_np(c["state"].params_gema), c["cfg"])
    g_file = str(tmp_path / "g.pt")
    assert "save_generator" in orbax_to_port.main(["--src", c["src"], "--dest", g_file,
                                                   "--generator-only"])
    for path in (c["dest"], g_file):
        model = ckpt.load_generator_checkpoint(path, device="cpu")
        _assert_state_dict_equal(model.state_dict(), gema, path)
        with torch.inference_mode():
            got = model(**_torch(batch)).numpy()
        err = float(np.abs(got - want).max())
        assert got.shape == want.shape and err <= 1e-5, f"{path}: boxes max-abs {err:.3e}"


def test_bare_params_need_generator_only_and_keep_the_torch_marker(converted, tmp_path):
    c = converted
    src = str(tmp_path / "params")
    jax_ckpt.save_checkpoint(src, c["state"].params_g)
    with open(src + ".gcfg.json", "w") as f:
        json.dump(dataclasses.asdict(c["jcfg"]), f)
    with open(src + ".converted.json", "w") as f:
        json.dump({"converted_from_torch": True, "hf_token_ids": True}, f)
    with pytest.raises(ValueError, match="--generator-only"):
        orbax_to_port.main(["--src", src, "--dest", str(tmp_path / "x.pt")])
    dest = str(tmp_path / "g.pt")
    assert ".converted.json" in orbax_to_port.main(["--src", src, "--dest", dest,
                                                    "--generator-only"])
    model = ckpt.load_generator_checkpoint(dest, device="cpu")
    assert model.cfg == c["cfg"]
    _assert_state_dict_equal(model.state_dict(),
                             generator_state_dict_from_jax(_np(c["state"].params_g), c["cfg"]),
                             "bare params")
    with open(dest + ".converted.json") as f:
        assert json.load(f)["hf_token_ids"]
    tok = LayoutTokenizer(max_length=16, vocab_dir=str(tmp_path / "no_vocab"))
    assert tok.backend == "hash"
    with pytest.raises(RuntimeError, match="converted from torch"):
        tok.require_hf_for_checkpoint(dest)


def test_vit_train_state_converts(narrow_vit, tmp_path):  # noqa: F811 (fixture)
    jcfg, cfg = tiny_configs(**VIT_CFG)
    state, _, _ = _jax_state(jcfg, seed=3)
    src = _save(state, jcfg, str(tmp_path / "run"))
    dest = str(tmp_path / "snapshot.pt")
    orbax_to_port.main(["--src", src, "--dest", dest])
    pstate = ckpt.restore_checkpoint(dest, port_train_state(cfg))
    np_state = _np(state)
    _assert_state_dict_equal(pstate.G.state_dict(),
                             generator_state_dict_from_jax(np_state.params_g, cfg), "vit G")
    _assert_state_dict_equal(pstate.D.state_dict(),
                             discriminator_state_dict_from_jax(np_state.params_d, cfg), "vit D")
    names = [n for n, p in pstate.D.named_parameters() if p in pstate.opt_d.state]
    assert any(n.startswith("backbone.blocks.1.") for n in names)
    mu = jax.tree.leaves(_np(state.opt_state_d))
    assert len(pstate.opt_d.state) == sum(1 for m in mu if m.ndim > 0) // 2  # mu and nu a leaf


@pytest.mark.parametrize("kind", ["layoutnet", "inception"])
def test_metric_network_checkpoints(kind, tmp_path):
    """``torch_convert``'s orbax output ({"params": tree}) -> the state dict
    the port's --layoutnet-ckpt / --inception-ckpt read."""
    if kind == "layoutnet":
        rng = np.random.default_rng(0)
        inputs = (rng.uniform(size=(2, 9, 4)).astype(np.float32), rng.integers(0, 13, (2, 9)),
                  np.zeros((2, 9), bool))
        tree = random_params(JaxLayoutNet(13), *inputs)
        want = layoutnet_state_dict_from_jax(tree)
    else:
        tree = inception_params()
        want = inception_state_dict_from_jax(tree)
    src, dest = str(tmp_path / kind), str(tmp_path / f"{kind}.pt")
    jax_ckpt.save_checkpoint(src, {"params": tree})
    orbax_to_port.main(["--kind", kind, "--src", src, "--dest", dest])
    if kind == "layoutnet":
        sd = load_layoutnet_state_dict(dest)
        LayoutNet(13).load_state_dict(sd, strict=True)
    else:
        sd = load_inception_params(dest, device="cpu").state_dict()
        want = {k: v for k, v in want.items() if k in sd}
        assert len(want) == len([k for k in sd if "num_batches_tracked" not in k])
    _assert_state_dict_equal({k: sd[k] for k in want}, want, kind)
