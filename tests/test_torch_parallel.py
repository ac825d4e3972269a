"""Multi-GPU training on the CPU: the port's data- and tensor-parallel step
over gloo ranks (spawned processes, ``parallel.distributed.spawn``, each
run with a deadline) against JAX's step and the port's one-process step.

Tiny dims (TINY_KW, one reconstruction-decoder and unconditional layer),
fp32, deterministic, each rank given its slice of one global z through
``make_train_step``'s ``z=``. The global batch is 4 and uneven: the first
two samples (data rank 0's) hold 9 valid elements, the last two (rank
1's) one each, so a per-rank mean of a masked loss differs from the
global one. Bars:

- DP 2 x 1 against JAX's ``make_train_step`` jitted on one CPU device at
  the global batch (which SPMD makes equal to JAX's DP step): the ranks'
  mean stats within rtol 5e-4 / atol 5e-5 (JAX's own TP bar,
  ``_tp_driver.py:98-99``); parameters after the step bit-equal on both
  ranks and within the slice-2 bar of JAX's (``test_torch_train_step``:
  2 lr_eff, under 0.1% of entries off by > 1e-6); the DP-averaged
  gradients of Gmain and Dmain within 1e-5 of each leaf's max |g| of
  JAX's global ones (the slice-2 gradient bar), the ranks' mean loss
  within 1e-5 (relative above 1);
- TP 1 x 2 and DP x TP 2 x 2 against the port's one-process step at the
  same bars (that step is held to JAX by ``test_torch_train_step``); TP
  1 x 2 also with dropout on (the ranks share the one-process step's
  generator seed and draw its masks);
- the reg steps: data parallel with the per-rank path-length shrink, the
  2-rank steps equal a one-rank step fed the two ranks' first halves;
  tensor parallel, the one-process steps (the penalties' double
  backward crosses the sharded layers).
"""

import os

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.models.generator import make_text_feature_fn as jax_text_feature_fn
from layoutdetr_tpu.parallel.mesh import _tp_spec
from layoutdetr_tpu.training import loss as jax_loss
from layoutdetr_tpu.training import optimizers as jax_opt
from layoutdetr_tpu.training import train_step as jax_step
from layoutdetr_tpu_torch.models.bert import BertSelfAttention
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import (
    Generator,
    text_reconstruction_loss,
    text_reconstruction_tokens,
)
from layoutdetr_tpu_torch.models.layers import Dense
from layoutdetr_tpu_torch.ops import attention
from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.parallel import tensor_parallel as tp
from layoutdetr_tpu_torch.training import loss as port_loss
from layoutdetr_tpu_torch.training.loss import LossWeights, d_main_loss, g_main_loss
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import (
    GANTrainState,
    make_d_reg_step,
    make_g_reg_step,
    make_train_step,
)
from layoutdetr_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)

import _torch_parallel_worker as worker
from test_torch_common import random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_train_step import _close_after_step

B, N, T = 4, 9, 16
LR = {"G": 1e-5 * 4 / 5, "D": 1e-5 * 16 / 17, "G_ema": 1e-5 * 4 / 5}
TIMEOUT_S = 240  # a spawned run's deadline: a hung collective fails its test


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N, T), np.int32)
    lens = rng.integers(2, T + 1, size=(B, N))
    mask[np.arange(T)[None, None, :] >= lens[..., None]] = 0
    pad = np.zeros((B, N), bool)
    pad[B // 2:, 1:] = True  # data rank 1's samples: one valid element each
    return dict(
        bboxes=rng.uniform(0.1, 0.9, (B, N, 4)).astype(np.float32),
        labels=rng.integers(0, 8, (B, N)),
        text_ids=rng.integers(1, 64, (B, N, T)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, 30, (B, N)),
        mask=~pad,
        background=rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
    )


def _model_kwargs(batch):
    return dict(bbox_class=batch["labels"], text_ids=batch["text_ids"],
                text_mask=batch["text_mask"], text_len=batch["text_len"],
                padding_mask=~batch["mask"], background=batch["background"])


def _jax_z(rng):
    """The z JAX's step draws for one phase (train_step.py:171-194, grad_accum 1)."""
    rng, _ = jax.random.split(rng)  # the text-pass split
    rng_z, _ = jax.random.split(rng)
    return np.asarray(jax.random.normal(rng_z, (B, N, 4)))


def _spawn(fn, world, model_parallel, spec, tmp):
    """Run ``fn`` over ``world`` gloo ranks on the CPU; each rank's record."""
    path = os.path.join(tmp, "spec.pt")
    torch.save(spec, path)
    distributed.spawn(fn, world, (path, tmp), model_parallel=model_parallel,
                      devices=["cpu"] * world, timeout_s=TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = tiny_configs(reconst_decoder_layers=1, uncond_encoder_layers=1)
    batch = _batch()
    kw = _model_kwargs(batch)
    pg = random_params(JaxGenerator(jcfg), z=np.zeros((B, N, 4), np.float32),
                       bbox_real=batch["bboxes"], reconst=True, **kw)
    pd = random_params(JaxDiscriminator(jcfg), bbox=batch["bboxes"], reconst=True, **kw, seed=1)
    states = (generator_state_dict_from_jax(pg, cfg), discriminator_state_dict_from_jax(pd, cfg))
    rng = jax.random.PRNGKey(1)
    rng_g, rng_d = jax.random.split(rng)
    z = (_jax_z(rng_g), _jax_z(rng_d))
    return jcfg, cfg, batch, pg, pd, states, z


@pytest.fixture(scope="module")
def jax_run(case):
    """JAX's step at the global batch, and its Gmain/Dmain losses and
    gradients with the step's z."""
    jcfg, cfg, batch, pg, pd, _, z = case
    g, d = JaxGenerator(jcfg), JaxDiscriminator(jcfg)
    vg, vd = {"params": pg}, {"params": pd}
    tx_g = jax_opt.build_optimizer(vg, reg_interval=4, frozen_substrings=jax_opt.G_FROZEN_SUBSTRINGS)
    tx_d = jax_opt.build_optimizer(vd, reg_interval=16, frozen_substrings=jax_opt.D_FROZEN_SUBSTRINGS)
    state = jax_step.GANTrainState.create(vg, vd, tx_g, tx_d)
    step = jax_step.make_train_step(
        g.apply, d.apply, tx_g, tx_d, batch_size=B, z_dim=4, max_elements=N, deterministic=True,
        text_feature_fn=jax_text_feature_fn(jcfg, flash=False), share_text_encoder=True,
        ema_freeze_labels=jax_opt.freeze_mask(vg, jax_opt.G_FROZEN_SUBSTRINGS))
    new, stats = jax.jit(step)(state, batch, jax.random.PRNGKey(1))
    out = dict(stats={k: float(v) for k, v in stats.items()},
               G=generator_state_dict_from_jax(jax.tree.map(np.asarray, new.params_g), cfg),
               D=discriminator_state_dict_from_jax(jax.tree.map(np.asarray, new.params_d), cfg),
               G_ema=generator_state_dict_from_jax(jax.tree.map(np.asarray, new.params_gema), cfg))

    tf = np.asarray(jax_text_feature_fn(jcfg, flash=False)(
        pg["text_encoder"], batch["text_ids"], batch["text_mask"]))
    jbatch = dict(batch, text_feat_g=tf, text_feat_d=tf)
    w = jax_loss.LossWeights()
    fns = {"g_main": lambda p: jax_loss.g_main_loss(g.apply, d.apply, {"params": p}, vd, jbatch,
                                                    z[0], None, w, True),
           "d_main": lambda p: jax_loss.d_main_loss(g.apply, d.apply, vg, {"params": p}, jbatch,
                                                    z[1], None, w, True)}
    for phase, params, to_sd in (("g_main", pg, generator_state_dict_from_jax),
                                 ("d_main", pd, discriminator_state_dict_from_jax)):
        (total, _), grads = jax.jit(jax.value_and_grad(fns[phase], has_aux=True))(params)
        out[phase] = dict(total=float(total), grads=to_sd(jax.tree.map(np.asarray, grads), cfg))
    return out


@pytest.fixture(scope="module")
def dp_run(case, tmp_path_factory):
    _, cfg, batch, _, _, states, z = case
    spec = dict(cfg=cfg, states=states, batch=batch, z=z, batch_size=B, deterministic=True,
                grads=True)
    return _spawn(worker.step_case, 2, 1, spec, str(tmp_path_factory.mktemp("dp")))


def _assert_stats(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        assert abs(got[k] - v) <= 5e-5 + 5e-4 * abs(v), f"{what} stat {k}: {got[k]} vs {v}"


def _mean_stats(recs):
    return {k: float(np.mean([r["stats"][k] for r in recs])) for k in recs[0]["stats"]}


def _assert_params(rec: dict, want: dict, what: str):
    for key in ("G", "D", "G_ema"):
        worst, n_off, n = _close_after_step(rec[key], want[key], LR[key], f"{what} {key}")
        print(f"{what} {key}: max-abs {worst:.3e}, {n_off} of {n} off by > 1e-6")


def test_dp_step_matches_jax_on_the_global_batch(dp_run, jax_run):
    _assert_stats(_mean_stats(dp_run), jax_run["stats"], "DP 2x1")
    for key in ("G", "D", "G_ema"):  # the replicas stay equal bit for bit
        for name, t in dp_run[0][key].items():
            assert torch.equal(t, dp_run[1][key][name]), (key, name)
    _assert_params(dp_run[0], jax_run, "DP 2x1")


def _local_normalizer_total(case, phase):
    """The reference DDP's loss: the mean of each rank's own masked means,
    computed without a grid."""
    _, cfg, batch, _, _, states, z = case
    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(states[0])
    D.load_state_dict(states[1])
    fn, zz = (g_main_loss, z[0]) if phase == "g_main" else (d_main_loss, z[1])
    totals = []
    for half in (slice(0, B // 2), slice(B // 2, B)):
        b = {k: torch.from_numpy(np.array(v[half])) for k, v in batch.items()}
        total, _ = fn(G.train(), D.train(), b, torch.from_numpy(zz[half]), LossWeights(), True)
        totals.append(float(total.detach()))
    return float(np.mean(totals))


@pytest.mark.parametrize("phase", ["g_main", "d_main"])
def test_uneven_masks_match_jax_global_loss_and_gradients(dp_run, jax_run, case, phase):
    """Rank 0 holds 9 valid elements a sample, rank 1 one: the ranks' mean
    loss and their averaged gradients are JAX's global ones, where the
    mean of per-rank masked means is off by far more than the bar."""
    want = jax_run[phase]
    got = float(np.mean([r["grads"][phase]["total"] for r in dp_run]))
    tol = 1e-5 * max(1.0, abs(want["total"]))
    assert abs(got - want["total"]) <= tol, (got, want["total"])
    assert abs(_local_normalizer_total(case, phase) - want["total"]) > 100 * tol
    grads = dp_run[0]["grads"][phase]["grads"]
    for name, g in grads.items():
        assert torch.equal(g, dp_run[1]["grads"][phase]["grads"][name]), name
    floor = 1e-3 * max(float(np.abs(v.numpy()).max()) for v in want["grads"].values())
    checked = 0
    for name, g in grads.items():
        w = want["grads"][name].numpy()
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * scale, f"{phase} grad {name}: {err:.3e} > 1e-5 x {scale:.3e}"
        checked += 1
    assert checked > 50


def test_collector_sums_moments_across_ranks(dp_run):
    """Rank 0 reports [1, 1], rank 1 [2, 2]: the mean on both is 1.5
    (test_multihost.py:74-79)."""
    assert [r["collector"] for r in dp_run] == [(1.5, 4), (1.5, 4)]


def test_replica_check_raises_on_a_divergent_replica(dp_run):
    """The check passed on the stepped replicas (inside the ranks), and a
    bias changed on one rank raises on both, naming it."""
    assert [r["mismatch"] for r in dp_run] == ["Replica mismatch at G/fc_z.bias"] * 2


def _one_process(case, deterministic=True):
    _, cfg, batch, _, _, states, z = case
    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(states[0])
    D.load_state_dict(states[1])
    state = GANTrainState.create(G, D, build_optimizer(G.train(), reg_interval=4),
                                 build_optimizer(D.train(), reg_interval=16))
    step = make_train_step(batch_size=B, z_dim=4, max_elements=N, deterministic=deterministic)
    stats = step(state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                 torch.Generator().manual_seed(0), z=tuple(torch.from_numpy(np.array(x)) for x in z))
    return dict(stats={k: float(v) for k, v in stats.items()}, G=state.G.state_dict(),
                D=state.D.state_dict(), G_ema=state.G_ema.state_dict())


@pytest.mark.parametrize("world, model_parallel, deterministic", [
    (2, 2, True), (4, 2, True), (2, 2, False)], ids=["tp1x2", "dp2xtp2", "tp1x2-dropout"])
def test_tp_step_matches_the_one_process_step(case, tmp_path, world, model_parallel,
                                              deterministic):
    _, cfg, batch, _, _, states, z = case
    spec = dict(cfg=cfg, states=states, batch=batch, z=z, batch_size=B,
                deterministic=deterministic)
    recs = _spawn(worker.step_case, world, model_parallel, spec, str(tmp_path))
    want = _one_process(case, deterministic)
    what = f"{world // model_parallel}x{model_parallel}"
    _assert_stats(_mean_stats(recs), want["stats"], what)
    _assert_params(recs[0], want, what)
    # the replica check skipped the sharded tensors (one was changed on
    # a rank), then named the changed replicated one
    assert all(r["shard_skipped"] for r in recs)
    assert {r["mismatch"] for r in recs} == {"Replica mismatch at G/fc_z.bias"}


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["dp2", "tp2"])
def test_reg_steps_per_rank_pl_shrink_equal_one_rank(case, tmp_path, model_parallel):
    """The path-length step, then R1, over 2 ranks. Data parallel: each
    rank shrinks its batch of 2 to its first sample, and a one-rank step
    whose first half is those two samples gives the same penalties,
    pl_mean and updates. Tensor parallel: both ranks hold the batch of 4,
    and the double backward crosses the sharded layers."""
    _, cfg, batch, _, _, states, _ = case
    rng = np.random.default_rng(7)
    z = rng.normal(size=(2, N, 4)).astype(np.float32)
    noise = rng.normal(size=(2, N, 4)).astype(np.float32)
    spec = dict(cfg=cfg, states=states, batch=batch, batch_size=B, z=z, noise=noise)
    recs = _spawn(worker.reg_case, 2, model_parallel, spec, str(tmp_path))

    # data parallel: rank 0's first sample, rank 1's, then the rest
    order = [0, 2, 1, 3] if model_parallel == 1 else [0, 1, 2, 3]
    one = {k: torch.from_numpy(np.array(v)[order]) for k, v in batch.items()}
    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(states[0])
    D.load_state_dict(states[1])
    state = GANTrainState.create(G, D, build_optimizer(G.train(), reg_interval=4),
                                 build_optimizer(D.train(), reg_interval=16))
    weights = LossWeights(pl_weight=2.0, r1_gamma=1.0)
    stats = make_g_reg_step(weights, 4, N)(state, one, torch.Generator(), z=torch.from_numpy(z),
                                           pl_noise=torch.from_numpy(noise))
    stats.update(make_d_reg_step(weights)(state, one))
    assert recs[0]["pl_mean"] == recs[1]["pl_mean"]
    assert abs(recs[0]["pl_mean"] - float(state.pl_mean)) <= 1e-6 * abs(float(state.pl_mean))
    _assert_stats(_mean_stats(recs), {k: float(v) for k, v in stats.items()}, "reg steps")
    for key in ("G", "D"):
        assert all(torch.equal(t, recs[1][key][n]) for n, t in recs[0][key].items()), key
        _close_after_step(recs[0][key], getattr(state, key).state_dict(), LR[key], f"reg {key}")


@pytest.mark.parametrize("head_offset, heads", [(0, 2), (2, 2), (1, 1), (3, 1)])
def test_keep_mask_of_a_tp_rank_is_the_whole_heads_slice(head_offset, heads):
    whole = attention.keep_mask(11, 3, 4, 20, 0.1)
    part = attention.keep_mask(11, 3, heads, 20, 0.1, head_offset=head_offset, total_heads=4)
    assert torch.equal(part, whole[:, head_offset:head_offset + heads])


def test_tp_rules_shard_what_jax_shards(case):
    """Every port parameter that ``shard_state_dict`` splits is a JAX leaf
    whose ``TP_RULES`` spec splits the same axis (a kernel [in, out] is a
    weight [out, in]), and every JAX leaf the rules split is split here:
    leaves are told apart by filling each with its own index."""
    jcfg, cfg, batch, pg, pd, _, _ = case
    for params, to_sd in ((pg, generator_state_dict_from_jax),
                          (pd, discriminator_state_dict_from_jax)):
        flat, treedef = jax.tree_util.tree_flatten_with_path(params)
        names = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
        tagged = jax.tree_util.tree_unflatten(
            treedef, [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(flat)])
        sd = to_sd(tagged, cfg)
        jax_split = {i for i, n in enumerate(names) if _tp_spec(n) != jax.sharding.PartitionSpec()}
        port_split = set()
        for name, t in sd.items():
            tags = torch.unique(t)
            if len(tags) != 1 or float(tags[0]) == 0:  # filled by the converter: no JAX leaf
                continue
            i = int(tags[0]) - 1
            dim = tp.tp_dim(name)
            if dim is None:
                assert i not in jax_split, (name, names[i])
                continue
            port_split.add(i)
            spec = _tp_spec(names[i])
            jax_axis = list(spec).index("model")
            torch_axis = {0: 1, 1: 0}[jax_axis] if t.dim() == 2 else 0
            assert dim == torch_axis, (name, names[i], spec)
        assert port_split == jax_split


def test_shard_state_dict_splits_by_the_rules():
    sd = {"encoder.layer.0.attention.self.query.weight": torch.arange(24.).view(4, 6),
          "encoder.layer.0.attention.self.query.bias": torch.arange(4.),
          "encoder.layer.0.attention.output.dense.weight": torch.arange(24.).view(6, 4),
          "encoder.layer.0.attention.output.dense.bias": torch.arange(6.),
          "linear2.weight": torch.arange(8.).view(2, 4), "fc_z.weight": torch.ones(3, 3)}
    shards = [tp.shard_state_dict(sd, r, 2) for r in range(2)]
    assert shards[1]["encoder.layer.0.attention.self.query.weight"].shape == (2, 6)
    assert shards[1]["encoder.layer.0.attention.output.dense.weight"].shape == (6, 2)
    assert shards[0]["encoder.layer.0.attention.output.dense.bias"].shape == (6,)
    assert shards[0]["fc_z.weight"] is sd["fc_z.weight"]
    for name, t in sd.items():  # the ranks' slices put back together
        dim = tp.tp_dim(name)
        back = t if dim is None else torch.cat([s[name] for s in shards], dim)
        assert torch.equal(back, t), name


def test_rank_grid_and_buckets():
    # the model axis is inner (mesh.py:38-40)
    assert [distributed.grid_coords(r, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    ts = [torch.zeros(10), torch.zeros(10, dtype=torch.float64), torch.zeros(30), torch.zeros(5)]
    assert list(distributed.buckets(ts, cap=160)) == [[0, 2], [3], [1]]
    assert distributed.rank_seed(5, 0) == 5 and distributed.rank_seed(5, 1) != 5
    assert distributed.grid() is None
    assert port_loss._dp_shares({}, 0) == (1.0, 1.0)  # alone: the masked means as they are
    x = torch.tensor(2.0, requires_grad=True)
    assert distributed.data_mean(x) is x


def test_text_reconstruction_tokens_count_the_lm_loss_targets(case):
    """The token count that scales the text loss under data parallelism is
    the count ``lm_loss_label_smoothed`` divides by: the decoder's targets
    that are not ignored, in valid elements."""
    _, cfg, batch, _, _, _, _ = case
    seen = {}

    def decoder(ids, mask, labels, row_mask, **kw):
        seen.update(labels=labels, row_mask=row_mask)
        return None, torch.zeros(())

    ids, valid = torch.from_numpy(batch["text_ids"]), torch.from_numpy(batch["mask"])
    text_reconstruction_loss(decoder, cfg, ids, torch.from_numpy(batch["text_mask"]), valid)
    want = ((seen["labels"][:, 1:] != -100) & seen["row_mask"][:, None]).sum()
    got = text_reconstruction_tokens(ids, valid, cfg.pad_token_id)
    assert int(got) == int(want) and 0 < int(got) < valid.sum() * (T - 1)


@pytest.mark.parametrize("what", ["column", "row", "heads"])
def test_a_sharded_layer_outside_a_grid_raises(what):
    """A layer reads its TP role from its weights' shapes: one that holds a
    slice cannot run without its model group, and raises rather than
    compute on the slice alone; sharding twice raises too."""
    _, cfg = tiny_configs()
    if what == "heads":
        layer = BertSelfAttention(cfg.encoder_bert_config(), cfg.bert_f_dim)
        tp.shard_module_(layer, 0, 2)
        args = (torch.zeros(1, 3, cfg.bert_f_dim), torch.zeros(1, 1, 1, 3))
        with pytest.raises(ValueError, match="already sharded"):
            tp.shard_module_(layer, 0, 2)
    else:
        layer = Dense(6, 4)
        dim = 0 if what == "column" else 1
        layer.weight.data = layer.weight.data.narrow(dim, 0, layer.weight.shape[dim] // 2)
        args = (torch.zeros(1, layer.weight.shape[1]),)
    with pytest.raises(RuntimeError, match="outside a grid"):
        layer(*args)
