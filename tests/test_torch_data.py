"""The data feed: the port's synthetic zip, dataset, sampler, loader and
device cache vs the JAX package's, on one synthetic zip."""

import itertools
import json
import zipfile

import numpy as np
import pytest
import torch

from layoutdetr_tpu.data import dataset as jds
from layoutdetr_tpu.data.synthetic import make_synthetic_zip as jax_make_zip
from layoutdetr_tpu_torch.data import dataset as ds
from layoutdetr_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
    build_host_arrays,
    estimate_bytes,
    gather_batch,
    should_enable,
)
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip

from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

N_SAMPLES, SIZE, T = 12, 48, 32


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    kw = dict(num_samples=N_SAMPLES, image_size=64, max_elements=9, seed=3, structured=True)
    return make_synthetic_zip(str(d / "port.zip"), **kw), jax_make_zip(str(d / "jax.zip"), **kw)


def _datasets(path, **kw):
    """Both loaders decoding with PIL (the native decoders are held to each
    other in test_torch_native.py)."""
    return (ds.LayoutDataset(path, background_size=SIZE, max_text_length=T, use_native=False, **kw),
            jds.LayoutDataset(path, background_size=SIZE, max_text_length=T, use_native=False, **kw))


def test_synthetic_zip_matches_jax(zips):
    port, ref = zips
    with zipfile.ZipFile(port) as a, zipfile.ZipFile(ref) as b:
        assert a.namelist() == b.namelist()
        assert json.loads(a.read("non_image.json")) == json.loads(b.read("non_image.json"))
        assert all(a.read(n) == b.read(n) for n in a.namelist())


def test_dataset_matches_jax(zips):
    port, ref = _datasets(zips[0])
    assert len(port) == len(ref) == N_SAMPLES and port.num_bbox_labels == ref.num_bbox_labels
    assert port.measured_max_text_tokens() == ref.measured_max_text_tokens()
    for i in (0, 5, N_SAMPLES - 1):
        a, b = port[i], ref[i]
        for k in ("bboxes", "labels", "text_ids", "text_mask", "text_len", "mask", "padding_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["texts"] == b["texts"] and a["name"] == b["name"]
        assert a["background"].shape == (SIZE, SIZE, 3)
        np.testing.assert_allclose(a["background"], b["background"], rtol=0, atol=1e-6)
    got, want = port.collate([3, 1, 3]), ref.collate([3, 1, 3])
    assert set(got) == set(ds.BATCH_KEYS)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    # the sample cache holds the decode products once warmed
    port.warm_cache()
    assert len(port._cache) == N_SAMPLES
    np.testing.assert_array_equal(port.collate([3, 1, 3])["background"], got["background"])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sampler_order_matches_jax(seed):
    for rank, replicas in ((0, 1), (1, 3)):
        a = ds.InfiniteSampler(N_SAMPLES, rank=rank, num_replicas=replicas, seed=seed)
        b = jds.InfiniteSampler(N_SAMPLES, rank=rank, num_replicas=replicas, seed=seed)
        assert list(itertools.islice(a, 100)) == list(itertools.islice(b, 100))


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_loader_gives_the_collate_stream(zips, workers):
    dataset = ds.LayoutDataset(zips[0], background_size=SIZE, max_text_length=T)
    dataset.warm_cache()
    loader = ds.PrefetchLoader(dataset, 3, ds.InfiniteSampler(N_SAMPLES, seed=4), num_workers=workers)
    try:
        got = [next(loader) for _ in range(6)]
    finally:
        loader.close()
    order = iter(ds.InfiniteSampler(N_SAMPLES, seed=4))
    for batch in got:
        want = dataset.collate([next(order) for _ in range(3)])
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    assert all(not p.is_alive() for p in loader._procs)
    if workers == 0:
        assert not loader._thread.is_alive()


def test_prefetch_loader_reraises_a_worker_error(zips):
    dataset = ds.LayoutDataset(zips[0], background_size=SIZE, max_text_length=T)

    def broken(indices):
        raise OSError("corrupt entry")

    dataset.collate = broken
    loader = ds.PrefetchLoader(dataset, 2, ds.InfiniteSampler(N_SAMPLES), num_workers=0)
    for _ in range(2):  # sticky: every later call raises too
        with pytest.raises(RuntimeError, match="worker died"):
            next(loader)


def test_device_cache_gather_equals_collate(zips):
    dataset = ds.LayoutDataset(zips[0], background_size=SIZE, max_text_length=T)
    host = build_host_arrays(dataset)
    assert sum(v.nbytes for v in host.values()) == estimate_bytes(dataset)
    cache = DeviceDatasetCache(dataset, "cpu")
    idxs = [4, 0, 11, 4]
    got = gather_batch(cache.arrays, cache.put_indices(idxs))
    want = ds.to_device(dataset.collate(idxs), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6, msg=k)
        else:
            assert torch.equal(got[k], v), k
    assert want["text_ids"].dtype == torch.int64 and want["mask"].dtype == torch.bool
    assert should_enable(dataset, "on") and not should_enable(dataset, "off")
    assert should_enable(dataset, "auto") and not should_enable(dataset, "auto", budget_gb=1e-6)


def test_prefetch_workers_end_on_close_under_a_sigterm_handler(zips):
    """Forked workers inherit the parent's handlers (the train CLI's SIGTERM
    one finishes a tick instead of exiting) and ignore SIGTERM themselves (a
    stop sent to the process group is the trainer's): close() must still end
    them."""
    import signal

    dataset = ds.LayoutDataset(zips[0], background_size=SIZE, max_text_length=T)
    old = signal.signal(signal.SIGTERM, lambda signum, frame: None)
    try:
        loader = ds.PrefetchLoader(dataset, 2, ds.InfiniteSampler(N_SAMPLES), num_workers=2)
        for _ in range(4):  # both workers running
            next(loader)
        loader.close()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert all(p.exitcode == -signal.SIGKILL for p in loader._procs)


def test_prefetch_workers_outlive_a_sigterm_to_the_group(zips):
    """A stop sent to the trainer's process group (GNU timeout signals its
    child and then its group) reaches the workers too: they ignore it, and
    the batches go on in order until the trainer closes the loader."""
    import os
    import signal
    import time

    dataset = ds.LayoutDataset(zips[0], background_size=SIZE, max_text_length=T)
    want = ds.PrefetchLoader(dataset, 2, ds.InfiniteSampler(N_SAMPLES), num_workers=0)
    want = [next(want)["labels"] for _ in range(6)]
    loader = ds.PrefetchLoader(dataset, 2, ds.InfiniteSampler(N_SAMPLES), num_workers=2)
    try:
        got = [next(loader)["labels"] for _ in range(2)]
        for p in loader._procs:
            os.kill(p.pid, signal.SIGTERM)
        time.sleep(0.3)  # a worker the signal ends is gone by then (no hang below)
        assert all(p.is_alive() for p in loader._procs)
        got += [next(loader)["labels"] for _ in range(4)]
    finally:
        loader.close()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_loader_drops_what_the_consumer_never_reads(zips, workers):
    """``drop``: the worker decodes the batch whole and hands it over
    without those keys; the rest is the collate stream."""
    dataset = ds.LayoutDataset(zips[0], background_size=SIZE, max_text_length=T,
                               load_patches=True)
    loader = ds.PrefetchLoader(dataset, 2, ds.InfiniteSampler(N_SAMPLES, seed=4),
                               num_workers=workers, drop=("patches_orig", "background"))
    try:
        got = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    order = iter(ds.InfiniteSampler(N_SAMPLES, seed=4))
    for batch in got:
        want = dataset.collate([next(order) for _ in range(2)])
        assert set(want) - set(batch) == {"patches_orig", "background"}
        for k in batch:
            np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


def test_prefetch_workers_die_with_a_killed_trainer(zips, tmp_path):
    """A trainer killed without close(), here by the second SIGTERM of the
    CLI's handler ("send again to kill now"), leaves no loader worker
    behind, although the workers ignore SIGTERM."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from test_torch_common import REPO_ROOT

    pids = tmp_path / "pids"
    script = f"""
import os, signal, sys, time
from layoutdetr_tpu_torch.data import dataset as ds
from layoutdetr_tpu_torch.train import StopRequest
signal.signal(signal.SIGTERM, StopRequest())
dataset = ds.LayoutDataset({zips[0]!r}, background_size={SIZE}, max_text_length={T})
loader = ds.PrefetchLoader(dataset, 2, ds.InfiniteSampler({N_SAMPLES}), num_workers=2)
next(loader)
with open({str(pids)!r} + ".tmp", "w") as f:
    f.write(" ".join(str(p.pid) for p in loader._procs))
os.rename({str(pids)!r} + ".tmp", {str(pids)!r})
while True:
    time.sleep(0.05)
"""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env)
    try:
        deadline = time.monotonic() + 60
        while not pids.exists():
            assert proc.poll() is None and time.monotonic() < deadline, "no loader workers"
            time.sleep(0.05)
        workers = [int(p) for p in pids.read_text().split()]
        proc.send_signal(signal.SIGTERM)  # a stop request: the trainer lives on
        time.sleep(1.5)  # past TERM_REPEAT_S: the second one kills
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()

    def alive(pid: int) -> bool:
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except FileNotFoundError:
            return False

    deadline = time.monotonic() + 10
    while any(map(alive, workers)) and time.monotonic() < deadline:
        time.sleep(0.05)
    survivors = [pid for pid in workers if alive(pid)]
    for pid in survivors:
        os.kill(pid, signal.SIGKILL)
    assert not survivors, f"loader workers {survivors} outlived their trainer"
