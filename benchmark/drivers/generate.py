"""Driver of the serving cells: the port's batch entry ``generate_layouts``
at the shape of the HTTP server's ``/prediction``.

A request is one banner page, its background ImageNet-normalized on the
host as a caller hands it over, and its (string, label) elements; it asks
for the mix's ``num_results`` layouts, served as the server serves them
(``serving/api_server.py``'s ``generate_banners``): one forward over the
page repeated, the noise of layout ``i`` from ``RandomState(1 + i)``. Here
that forward is ``generate_layouts`` over the page ``num_results`` times
with ``seed=1``, which draws the same noise; the server's jitter, ranking
and PIL rendering are left out.

Set-up makes G's weights on the card from the seed with the benchmark's
reference and loads them into the port's ``Generator`` (eval, no
gradients), and draws the mix's distinct pages. Requests arrive at the
mix's fixed rate (``traffic.pages.Arrivals``) and one server takes them in
turn, as the server's single-threaded ``HTTPServer`` does; a request that
has not yet arrived is waited for. ``WARMUP_REQUESTS`` requests warm up the
one shape; the window then serves until ``--seconds`` have passed.
``layouts_per_s`` is every layout returned in the window over its wall
time; each request's service time is the host clock around its
``generate_layouts`` call, and its wait adds the time it queued.

Once the window has closed and the port's model is freed, the reference
makes G again from the seed and, for a seeded sample of
``CHECKED_REQUESTS`` served requests and the one with the most elements,
works out the tokens, the noise and G's forward itself; the raw boxes of
the real elements are compared.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import common, readers, trace as tracing
from benchmark.reference import train_step as ref
from benchmark.reference.config import GeneratorConfig as RefConfig
from benchmark.reference.generator import Generator as RefGenerator
from benchmark.traffic import grammar, pages, tokenizer

SEED_BASE = 1  # generate_banners' seed_base: layout i's noise from RandomState(1 + i)
WARMUP_REQUESTS = 2
PROFILED_REQUESTS = 8
CHECKED_REQUESTS = 24  # the limit of box_gap was set at this sample


def make_requests(mix: dict, seed: int, image_size: int, device):
    """The mix's distinct pages as the port's ``LayoutRequest``s."""
    from layoutdetr_tpu_torch.generate import LayoutRequest

    drawn = pages.draw_pages(mix, seed, image_size, device)
    backgrounds = pages.normalize(drawn.backgrounds).cpu().numpy()
    return [LayoutRequest(backgrounds[i], drawn.strings(i), drawn.label_names(i))
            for i in range(len(drawn))]


def build_program(cfg: dict, seed: int, device):
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.models.generator import Generator

    weights = ref.make_generator(RefConfig(**cfg), seed, device)
    with torch.device(device):
        G = Generator(GeneratorConfig(**cfg))
    G.load_state_dict(weights.state_dict())
    del weights
    return G.eval().requires_grad_(False)


def serve(model, request, num_results: int, device):
    """One request through the port: its layouts' raw boxes [n, 9, 4] and
    real-element masks [n, 9], and how many layouts came back."""
    from layoutdetr_tpu_torch.generate import generate_layouts

    with record_function("bench.generate_layouts"):
        layouts = generate_layouts(model, [request] * num_results, seed=SEED_BASE, device=device)
    return (np.stack([l.raw for l in layouts]), np.stack([l.mask for l in layouts]),
            len(layouts))


def reference_boxes(G: RefGenerator, request, num_results: int, device) -> np.ndarray:
    """The reference's raw boxes [num_results, 9, 4] of one request: the
    strings tokenized, the labels indexed and padded to 9 elements, layout
    i's noise from ``RandomState(SEED_BASE + i)``, as the server defines them."""
    cfg = G.cfg
    n = cfg.max_elements
    k = len(request.strings)
    texts = [list(request.strings) + [""] * (n - k)] * num_results
    labels = [[grammar.LABELS.index(l) for l in request.labels] + [0] * (n - k)] * num_results
    pad = [[j >= k for j in range(n)]] * num_results
    z = np.stack([np.random.RandomState(SEED_BASE + i).randn(n, cfg.z_dim).astype(np.float32)
                  for i in range(num_results)])
    ids, mask, lens = tokenizer.encode(texts, cfg.max_text_length, cfg.text_len_table)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    with torch.no_grad():
        out = G(t(z), t(labels, torch.long), None, t(ids, torch.long), t(mask), t(lens, torch.long),
                t(pad, torch.bool), t(np.stack([request.background] * num_results)))
    return out.float().cpu().numpy()


def reference_outputs(cfg: dict, seed: int, device, requests: list, picked: List[int],
                      num_results: int, tf32: bool = False) -> List[np.ndarray]:
    """The reference's raw boxes of the requests for pages ``picked``; with
    ``tf32`` its products run in TF32 (the control)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        G = ref.make_generator(RefConfig(**cfg), seed, device).eval().requires_grad_(False)
        return [reference_boxes(G, requests[p], num_results, device) for p in picked]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def box_gap(program: List[np.ndarray], reference: List[np.ndarray], masks: List[np.ndarray]) -> float:
    """Largest |program - reference| over the real elements' raw boxes."""
    return max(float(np.abs(p[m] - r[m]).max()) for p, r, m in zip(program, reference, masks))


def checked_sample(served: list, seed: int) -> List[int]:
    """Indices of the served requests to check: a sample drawn from the
    seed, and the request with the most elements."""
    pick = np.random.default_rng([seed, 4]).choice(
        len(served), min(CHECKED_REQUESTS, len(served)), replace=False).tolist()
    longest = max(range(len(served)), key=lambda i: int(served[i][2][0].sum()))
    return pick if longest in pick else pick + [longest]


def run(ctx) -> common.Outcome:
    device, card = ctx.device, common.Card(ctx.device)
    cfg, spec, mix = ctx.cfg["generator"], ctx.spec, ctx.mix
    n_results = int(mix["num_results"])
    requests = make_requests(mix, ctx.seed, cfg["background_size"], device)
    common.stamp(ctx.t_start, "requests drawn")
    model = build_program(cfg, ctx.seed, device)
    common.stamp(ctx.t_start, "model built")
    arrivals = pages.Arrivals(mix, ctx.seed)

    for k in range(WARMUP_REQUESTS):
        serve(model, requests[arrivals.page(k)], n_results, device)
    card.sync()
    card.reset_peak()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    served, service, waits, failed, layouts = [], [], [], 0, 0
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        ahead = arrivals.at(k) - (time.perf_counter() - t0)
        if ahead > 0:
            time.sleep(ahead)
        page = arrivals.page(k)
        t_a = time.perf_counter()
        raw, mask, n = serve(model, requests[page], n_results, device)
        t_b = time.perf_counter()
        failed += int(n != n_results)
        layouts += n
        served.append((page, raw, mask))
        service.append(t_b - t_a)
        waits.append(t_b - t0 - arrivals.at(k))
        k += 1
    window_s = time.perf_counter() - t0
    peak = card.peak_bytes()
    backlog = arrivals.arrived(window_s) - k
    common.log(f"window: {k} requests of {n_results} layouts in {window_s:.3f} s, {backlog} more "
               f"arrived and queued; service p95 {readers.p95(service) * 1e3:.3f} ms over "
               f"{len(service)} requests, wait with the queue p95 {readers.p95(waits) * 1e3:.3f} ms; "
               f"set-up {setup_s:.3f} s; peak {peak / 2**30:.2f} GiB")

    probe = None
    if ctx.trace:
        from benchmark.harness import census

        pool = iter(range(k, 10 ** 9))

        def one():
            serve(model, requests[arrivals.page(next(pool))], n_results, device)

        summary = tracing.profile(one, PROFILED_REQUESTS, card.sync)
        busy = tracing.device_busy(one, PROFILED_REQUESTS, card.sync)
        probe = dict(summary=summary, busy=busy, window_s=window_s, window_steps=k,
                     chips=ctx.chips, peak_bytes=peak, service_s=service,
                     census=census.generate_census(RefConfig(**cfg), n_results))
    del model
    card.free()

    t_ref = time.perf_counter()
    pick = checked_sample(served, ctx.seed)
    want = reference_outputs(cfg, ctx.seed, device, requests, [served[i][0] for i in pick],
                             n_results)
    gap = box_gap([served[i][1] for i in pick], want, [served[i][2] for i in pick])
    common.log(f"reference: {len(pick)} requests in {time.perf_counter() - t_ref:.2f} s")
    checks = [common.Check("box_gap", gap, spec["limits"]["box_gap"])]
    return common.Outcome(
        e2e=dict(setup_s=setup_s, layouts_per_s=layouts / window_s),
        attempted=k, failed=failed, checks=checks, memory_peak_bytes=peak,
        chips=ctx.chips, device_kind=card.kind(), probe=probe)
