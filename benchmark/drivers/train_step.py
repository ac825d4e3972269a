"""Driver of the training cells: the port's main GAN train step.

Set-up builds one train state, the weights made on the card from the seed
by the benchmark's reference and loaded into the port's G and D, with
``GANTrainState.create`` over ``build_optimizer`` (G: lazy-regularization
interval 4, D: 16) and ``make_train_step(share_text_encoder=True)``, as the
port's training run builds them. The traffic's pages go to the card once;
each step gathers ``batch`` rows of a seeded permutation there.

The first ``CHECKED_STEPS`` steps warm up every shape and are the ones
checked: their losses, the first gradient as Adam took it (from Adam's
first moment after step 1) and each leaf's change over the checked steps,
in G, D and G_ema. Then the window: steps back to back, the losses copied to
the host every ``STATS_EVERY`` steps in one copy (as the training loop
does), until ``--seconds`` have passed at such a copy;
``train_images_per_s`` is every image trained in the window over its wall
time. A traced run then profiles ``PROFILED_STEPS`` further steps.

Once the window has closed and the port's state is freed, the reference
makes the same weights again from the seed and runs the checked steps on
the same rows with the same generators.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import common, compare, trace as tracing
from benchmark.reference import train_step as ref
from benchmark.reference.config import GeneratorConfig as RefConfig
from benchmark.traffic import pages

LOSS_PREFIXES = ("Loss/G/", "Loss/D/")
# The steps checked against the reference (the limits were set at this count),
# the steps between two copies of the losses to the host (the training
# loop's), and the steps a traced run profiles.
CHECKED_STEPS = 3
STATS_EVERY = 4
PROFILED_STEPS = 3


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step`` (1-based) of a run seeded ``seed``."""
    word = int(np.random.SeedSequence([seed, 2, step]).generate_state(1, np.uint32)[0])
    return torch.Generator().manual_seed(word)


def losses(stats: Dict[str, torch.Tensor]) -> List[float]:
    """The G and D losses of a step: each phase's terms summed on the host."""
    host = {k: float(v) for k, v in stats.items()}
    return [sum(v for k, v in host.items() if k.startswith(p)) for p in LOSS_PREFIXES]


def norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    if not tensors:
        return []
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).tolist()


def build_program(cfg: dict, seed: int, device, batch: int, t_start: float = 0.0):
    """The port's train state and step on ``device``, holding the weights the
    reference makes from ``seed``."""
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.training.optimizers import build_optimizer
    from layoutdetr_tpu_torch.training.train_step import GANTrainState, make_train_step

    card = common.Card(device)
    weights_g, weights_d = ref.make_models(RefConfig(**cfg), seed, device)
    card.sync()
    common.stamp(t_start, "weights made")
    gcfg = GeneratorConfig(**cfg)
    with torch.device(device):
        G, D = Generator(gcfg), Discriminator(gcfg)
    card.sync()
    common.stamp(t_start, "port's G and D built")
    G.load_state_dict(weights_g.state_dict())
    D.load_state_dict(weights_d.state_dict())
    del weights_g, weights_d
    card.sync()
    common.stamp(t_start, "weights loaded")
    opt_g = build_optimizer(G.train(), reg_interval=ref.G_REG_INTERVAL)
    opt_d = build_optimizer(D.train(), reg_interval=ref.D_REG_INTERVAL)
    common.stamp(t_start, "optimizers built")
    state = GANTrainState.create(G, D, opt_g, opt_d)
    step = make_train_step(batch_size=batch, z_dim=gcfg.z_dim, max_elements=gcfg.max_elements,
                           share_text_encoder=True)
    return state, step


def _trained(module: torch.nn.Module) -> list:
    return [p for p in module.parameters() if p.requires_grad]


def _first_gradients(opt: torch.optim.Optimizer, params: list) -> list:
    """Each parameter's gradient as Adam took it at its first step: its first
    moment over (1 - beta1); zeros where Adam holds no state (no gradient)."""
    beta1 = opt.param_groups[0]["betas"][0]
    out = []
    for p in params:
        st = opt.state.get(p, {})
        out.append(st["exp_avg"] / (1.0 - beta1) if "exp_avg" in st else torch.zeros_like(p))
    return out


def _to_host(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat float32 copy of ``tensors`` on the host."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors]).cpu()


def program_checked(state, step, pool: pages.DevicePool, seed: int, n: int,
                    corrupt=None) -> dict:
    """Run the first ``n`` steps of the port and read what is checked: the
    losses, the first gradients' norms, and each trained entry's change over
    the ``n`` steps (``delta_*``, kept on the host until the reference says
    which entries its gradient moves). ``corrupt(batch) -> batch`` plants a
    fault (the harness's own tests and its calibration)."""
    params = {"G": _trained(state.G), "D": _trained(state.D)}
    ema = [e for e, p in zip(state.G_ema.parameters(), state.G.parameters()) if p.requires_grad]
    start = {m: [p.detach().clone() for p in ps] for m, ps in params.items()}
    out = dict(losses=[], rows=[])
    for m, module in (("G", state.G), ("D", state.D)):
        out[f"names_{m}"] = [k for k, p in module.named_parameters() if p.requires_grad]
    for s in range(1, n + 1):
        idx = pool.next_indices()
        batch = pool.gather(idx)
        stats = step(state, batch if corrupt is None else corrupt(batch), step_generator(seed, s))
        out["losses"] += losses(stats)
        out["rows"].append(idx)
        if s == 1:
            out["grad_G"] = norms(_first_gradients(state.opt_g, params["G"]))
            out["grad_D"] = norms(_first_gradients(state.opt_d, params["D"]))
    for m, ps in (("G", params["G"]), ("D", params["D"]), ("G_ema", ema)):
        base = start["G" if m == "G_ema" else m]
        out[f"delta_{m}"] = _to_host([p.detach() - b for p, b in zip(ps, base)])
    return out


def reference_checked(cfg: dict, seed: int, device, pool: pages.DevicePool, rows: list,
                      batch: int, tf32: bool = False, programs: Sequence[dict] = (),
                      keep_deltas: bool = False) -> dict:
    """The reference's readings over the same rows and generators; with
    ``tf32`` it computes its products in TF32 (the control). Each change is
    the norm, leaf by leaf, of the entries its gradient moves beyond
    round-off in some checked step (``compare.moved_entries``): the
    reference's own, and, written into each of ``programs``
    (``program_checked``'s readings), theirs. ``moved_G``, ``moved_D``: the
    leaves it moves (``compare.moved``). ``keep_deltas`` keeps its own
    entries' changes, for a control read as a program."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        G, D = ref.make_models(RefConfig(**cfg), seed, device)
        state = ref.TrainState(G, D)
        start = {"G": [p.detach().clone() for p in state.params_g],
                 "D": [p.detach().clone() for p in state.params_d]}
        out = dict(losses=[], moved_G=None, moved_D=None)
        entries, nonzero = dict(G=None, D=None), dict(G=None, D=None)
        for s, idx in enumerate(rows, 1):
            res = ref.train_step(state, pool.gather(idx), step_generator(seed, s), batch_size=batch)
            out["losses"] += losses(res["stats"])
            for m, grads in (("G", res["grads_g"]), ("D", res["grads_d"])):
                leaf_norms = norms(grads)
                if s == 1:
                    out[f"grad_{m}"] = leaf_norms
                out[f"moved_{m}"] = compare.moved(leaf_norms, out[f"moved_{m}"])
                entries[m] = compare.moved_entries(grads, entries[m])
                nonzero[m] = compare.touched(grads, nonzero[m])
            del res
        for m in ("G", "D"):
            common.log(f"change_gap leaves out of {m}: "
                       f"{compare.left_out(out[f'moved_{m}'], entries[m], nonzero[m])}")
        del nonzero
        ema = [e for e, p in zip(state.G_ema.parameters(), state.G.parameters()) if p.requires_grad]
        for m, ps in (("G", state.params_g), ("D", state.params_d), ("G_ema", ema)):
            g = "G" if m == "G_ema" else m
            keep = entries[g]
            deltas = [p.detach() - b for p, b in zip(ps, start[g])]
            out[f"change_{m}"] = compare.masked_norms(deltas, keep)
            if keep_deltas:
                out[f"delta_{m}"] = _to_host(deltas)
            del deltas
            sizes = [p.numel() for p in ps]
            for prog in programs:
                theirs = prog[f"delta_{m}"].to(device).split(sizes)
                prog[f"change_{m}"] = compare.masked_norms(
                    [t.view_as(p) for t, p in zip(theirs, ps)], keep)
                del theirs
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def run(ctx) -> common.Outcome:
    device, card = ctx.device, common.Card(ctx.device)
    cfg, spec, mix = ctx.cfg["generator"], ctx.spec, ctx.mix
    batch = int(mix["batch"])
    gen_pages = pages.draw_pages(mix, ctx.seed, cfg["background_size"], device)
    pool = pages.DevicePool(gen_pages, mix, ctx.seed, cfg["max_text_length"],
                            cfg["max_text_length"], device)
    common.stamp(ctx.t_start, "pages on the device")
    state, step = build_program(cfg, ctx.seed, device, batch, ctx.t_start)
    common.stamp(ctx.t_start, "train state built")
    checked = program_checked(state, step, pool, ctx.seed, CHECKED_STEPS)
    common.stamp(ctx.t_start, "checked steps done")
    done = CHECKED_STEPS

    def one_step():
        nonlocal done
        done += 1
        with record_function("bench.feed"):
            rows = pool.gather(pool.next_indices())
        with record_function("bench.step"):
            return step(state, rows, step_generator(ctx.seed, done))

    card.sync()
    card.reset_peak()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    steps, failed, pending, marks = 0, 0, [], []
    while True:
        stats = one_step()
        pending.append(torch.stack([v.float() for v in stats.values()]))
        steps += 1
        if steps % STATS_EVERY == 0:
            with record_function("bench.stats_copy"):
                host = torch.stack(pending).cpu()
            failed += int((~torch.isfinite(host)).any(dim=1).sum())
            pending = []
            marks.append(time.perf_counter())
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    card.sync()
    window_s = time.perf_counter() - t0
    peak = card.peak_bytes()
    chunks = [b - a for a, b in zip([t0] + marks, marks)]
    common.log(f"window: {steps} steps of {batch} in {window_s:.3f} s; set-up {setup_s:.3f} s; "
               f"peak {peak / 2**30:.2f} GiB; {STATS_EVERY} steps took "
               f"{min(chunks):.3f}-{max(chunks):.3f} s; card {common.card_state()}")

    probe = None
    if ctx.trace:
        from benchmark.harness import census

        summary = tracing.profile(one_step, PROFILED_STEPS, card.sync)
        busy = tracing.device_busy(one_step, PROFILED_STEPS, card.sync)
        probe = dict(summary=summary, busy=busy, window_s=window_s, window_steps=steps,
                     chips=ctx.chips, peak_bytes=peak,
                     census=census.train_step_census(RefConfig(**cfg), batch))
    del state, step, one_step
    card.free()

    t_ref = time.perf_counter()
    reference = reference_checked(cfg, ctx.seed, device, pool, checked["rows"], batch,
                                  programs=[checked])
    gaps = compare.train_gaps(checked, reference)
    common.log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    for k, (gap, where) in gaps.items():
        common.log(f"{k} {gap!r}: {where}")
    limits = spec["limits"]
    checks = [common.Check(k, gaps[k][0], limits[k]) for k in limits]
    return common.Outcome(e2e=dict(setup_s=setup_s, train_images_per_s=steps * batch / window_s),
                          attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak,
                          chips=ctx.chips, device_kind=card.kind(), probe=probe)
