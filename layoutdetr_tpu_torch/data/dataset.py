"""The training data feed on the host: zip-backed dataset, sampler, loader.

Counterpart of ``layoutdetr_tpu/data/dataset.py`` (reference
training/dataset_layoutganpp.py:214-353 and torch_utils/misc.py:114-145),
with the same on-disk format (dataset_tool.py's zip: non_image.json plus
per-element PNGs), the same decode products and the same index stream:

- ``LayoutDataset``: fixed-shape tokenized text (``text_ids``,
  ``text_mask``, ``text_len``), boxes, labels, validity mask and the
  background resized with PIL LANCZOS and ImageNet-normalized, channels
  last. Decoded backgrounds and tokens are kept in a RAM cache
  (``warm_cache``) so a run decodes each PNG once. Patches and the
  full-resolution background are off by default (the losses never read
  them); ``load_patches`` and ``load_background_orig`` decode them for the
  image FID and the rendering, and the latter bypasses the cache.
- ``InfiniteSampler``: the rank-strided, epoch-shuffled stream with a
  sliding-window swap.
- ``PrefetchLoader``: collated numpy batches prefetched by one thread or
  by forked worker processes, re-ordered so that the stream is the same
  for any worker count. Workers return numpy and never touch CUDA; the
  main process copies a batch to the card (``to_device``).

The JAX package's native C++ decoder is not ported: PIL decodes.
"""

from __future__ import annotations

import json
import os
import threading
import zipfile
from typing import Iterator, Optional

import numpy as np

from layoutdetr_tpu_torch.data.tokenizer import LayoutTokenizer

MAX_ELEMENTS = 9  # dataset_tool.py:180 keeps layouts of <= 9 elements; the loader pads to 9
RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 1, 3)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 1, 3)
BATCH_KEYS = ("bboxes", "labels", "text_ids", "text_mask", "text_len", "mask", "padding_mask",
              "background")
INDEX_KEYS = ("labels", "text_ids", "text_len")  # int64 in a batch on the device (embedding lookups)


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> ImageNet-normalized float32 HWC."""
    return (arr.astype(np.float32) / 255.0 - RGB_MEAN) / RGB_STD


def denormalize_image(arr: np.ndarray) -> np.ndarray:
    """float HWC -> uint8 HWC."""
    x = (arr * RGB_STD + RGB_MEAN) * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


class LayoutDataset:
    """Zip-backed dataset of (bboxes, labels, texts, background) samples.

    ``cache`` keeps the decode products (resized uint8 background and
    token arrays) in RAM by raw index; ``"auto"`` turns it on when the
    estimated footprint fits ``cache_gb`` (env ``LAYOUTDETR_CACHE_GB``,
    default 8)."""

    def __init__(self, path: str, background_size: int = 256, max_text_length: int = 256,
                 max_size: Optional[int] = None, tokenizer: Optional[LayoutTokenizer] = None,
                 random_seed: int = 0, text_len_clip: Optional[int] = None, cache="auto",
                 cache_gb: Optional[float] = None, load_patches: bool = False,
                 load_background_orig: bool = False):
        if not path.endswith(".zip"):
            raise IOError("Path must point to a zip")
        self._path = path
        self.background_size = background_size
        self.load_patches = load_patches
        self.load_background_orig = load_background_orig
        self.tokenizer = tokenizer or LayoutTokenizer(max_length=max_text_length,
                                                      length_clip=text_len_clip)
        self._local = threading.local()
        with self._zip().open("non_image.json") as f:
            self._samples = json.load(f)["samples"]
        self.num_bbox_labels = self._samples[0][1]["attr"]["num_bbox_labels"]
        parts = os.path.normpath(path).split(os.sep)
        self.name = parts[-3] if len(parts) >= 3 else os.path.basename(path)

        self._raw_idx = np.arange(len(self._samples), dtype=np.int64)
        if max_size is not None and len(self._raw_idx) > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])

        if cache_gb is None:
            cache_gb = float(os.environ.get("LAYOUTDETR_CACHE_GB", "8"))
        per_sample = (background_size * background_size * 3
                      + MAX_ELEMENTS * (self.tokenizer.max_length * 8 + 4) + 512)
        fits = len(self._raw_idx) * per_sample <= cache_gb * 2 ** 30
        if cache == "auto":
            # the full-resolution background is decoded anyway: no cache
            cache = fits and not load_background_orig
        elif cache and not fits:
            raise ValueError(f"sample cache needs ~{len(self._raw_idx) * per_sample / 2 ** 30:.1f} GB "
                             f"but cache_gb={cache_gb}; raise LAYOUTDETR_CACHE_GB or pass cache=False")
        self._cache: Optional[dict] = {} if cache else None
        self._cache_lock = threading.Lock()

    def _zip(self) -> zipfile.ZipFile:
        """A zip handle per thread: zipfile is not thread-safe."""
        zf = getattr(self._local, "zipfile", None)
        if zf is None:
            zf = zipfile.ZipFile(self._path)
            self._local.zipfile = zf
        return zf

    def __len__(self):
        return len(self._raw_idx)

    def measured_max_text_tokens(self) -> int:
        """Max token count (CLS and SEP included) over every text of the
        dataset, from the metadata alone (``--max-text-length auto``)."""
        mx = 2
        for sample in self._samples:
            for s in sample[1]["texts"]:
                mx = max(mx, self.tokenizer.token_count(s))
        return mx

    def _decode_static(self, raw_idx: int, keep_orig: bool = False) -> dict:
        """The decode products worth caching: the resized uint8 background
        and the fixed-shape token arrays; with ``keep_orig`` also the
        full-resolution background ``bg_orig``."""
        import PIL.Image

        base_fname, meta = self._samples[raw_idx]
        texts = list(meta["texts"]) + [""] * (MAX_ELEMENTS - len(meta["labels"]))
        text_ids, text_mask, text_len = self.tokenizer.encode_batch(texts)
        with self._zip().open(base_fname + "_background_orig.png") as f:
            img = PIL.Image.open(f)
            bg_u8 = np.array(img.resize((self.background_size,) * 2, PIL.Image.LANCZOS))
            out = dict(bg_u8=bg_u8, text_ids=text_ids, text_mask=text_mask, text_len=text_len)
            if keep_orig:
                out["bg_orig"] = np.array(img)
        return out

    def static(self, raw_idx: int) -> dict:
        """``_decode_static`` through the cache."""
        if self._cache is None:
            return self._decode_static(raw_idx)
        out = self._cache.get(raw_idx)
        if out is None:
            out = self._decode_static(raw_idx)
            with self._cache_lock:
                self._cache[raw_idx] = out
        return out

    def warm_cache(self, verbose: bool = False) -> float:
        """Decode every sample into the cache (no-op when it is off); returns
        the seconds taken. Call before forking loader workers, which then
        share the warm cache copy-on-write."""
        if self._cache is None:
            return 0.0
        import time

        t0 = time.time()
        for raw in self._raw_idx:
            self.static(int(raw))
        dt = time.time() - t0
        if verbose:
            mb = sum(v["bg_u8"].nbytes + v["text_ids"].nbytes * 2 for v in self._cache.values())
            print(f"Sample cache warmed: {len(self._cache)} samples, {mb / 2 ** 20:.0f} MB, {dt:.1f} s")
        return dt

    def layout(self, raw_idx: int):
        """(bboxes [9, 4] f32, labels [9] int64, mask [9] bool) of one sample."""
        meta = self._samples[raw_idx][1]
        n_real = len(meta["labels"])
        bboxes = np.zeros((MAX_ELEMENTS, 4), np.float32)
        bboxes[:n_real] = np.asarray(meta["bboxes"], np.float32)
        labels = np.zeros((MAX_ELEMENTS,), np.int64)
        labels[:n_real] = np.asarray(meta["labels"], np.int64)
        return bboxes, labels, np.arange(MAX_ELEMENTS) < n_real

    def _read_image(self, fname: str) -> np.ndarray:
        import PIL.Image

        with self._zip().open(fname) as f:
            return np.array(PIL.Image.open(f))

    def __getitem__(self, idx: int) -> dict:
        raw_idx = int(self._raw_idx[idx])
        base_fname, meta = self._samples[raw_idx]
        bboxes, labels, mask = self.layout(raw_idx)
        if self.load_background_orig:  # one decode gives both; bypasses the cache
            static = self._decode_static(raw_idx, keep_orig=True)
        else:
            static = self.static(raw_idx)
        out = dict(
            name=meta["attr"]["name"], W_page=meta["attr"]["width"], H_page=meta["attr"]["height"],
            bboxes=bboxes, labels=labels,
            texts=list(meta["texts"]) + [""] * (MAX_ELEMENTS - len(meta["labels"])),
            text_ids=static["text_ids"], text_mask=static["text_mask"],
            text_len=static["text_len"], mask=mask, padding_mask=~mask,
            background=normalize_image(static["bg_u8"]),
        )
        if self.load_background_orig:
            out["background_orig"] = normalize_image(static["bg_orig"])
        if self.load_patches:
            out.update(self._load_patches(base_fname, len(meta["labels"])))
        return out

    def _load_patches(self, base_fname: str, n_real: int) -> dict:
        """``patches_orig``: the elements' original patches [9, Hp, Wp, 3]
        (dataset_layoutganpp.py:281-328), ImageNet-normalized, zero past the
        real elements (1024^2 when the layout has none). The image FID's
        compositing reads nothing else of the patches."""
        patches_orig = None
        for i in range(n_real):
            orig = self._read_image(f"{base_fname}_{i}_patch_orig.png")
            if patches_orig is None:
                patches_orig = np.zeros((MAX_ELEMENTS,) + orig.shape, np.float32)
            patches_orig[i] = normalize_image(orig)
        if patches_orig is None:
            patches_orig = np.zeros((MAX_ELEMENTS, 1024, 1024, 3), np.float32)
        return dict(patches_orig=patches_orig)

    def collate(self, indices) -> dict:
        """Stack samples into a batch of numpy arrays (no strings); with
        ``load_patches`` also ``patches_orig``, with
        ``load_background_orig`` also ``background_orig`` and the page sizes
        ``W_page``/``H_page``."""
        items = [self[i] for i in indices]
        keys = list(BATCH_KEYS)
        if self.load_patches:
            keys.append("patches_orig")
        if self.load_background_orig:
            keys.append("background_orig")
        batch = {key: np.stack([it[key] for it in items]) for key in keys}
        if self.load_background_orig:
            for key in ("W_page", "H_page"):
                batch[key] = np.array([it[key] for it in items], np.int64)
        return batch


def to_device(host_batch: dict, device) -> dict:
    """A collated numpy batch -> the train step's tensors on ``device``:
    ``INDEX_KEYS`` as int64, copied from pinned memory without blocking
    the host when ``device`` is a card."""
    import torch

    device = torch.device(device)
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in INDEX_KEYS:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class InfiniteSampler:
    """Rank-strided shuffled infinite index stream with window shuffle
    (torch_utils/misc.py:114-145); deterministic per (seed, rank)."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        if dataset_size <= 0:
            raise ValueError("InfiniteSampler needs a non-empty dataset")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class PrefetchLoader:
    """Collated batches prefetched in the background: one thread
    (``num_workers=0``) or that many forked worker processes. Batches
    carry sequence numbers and are re-ordered, so the stream is the same
    for any worker count. A worker's exception is re-raised by
    ``__next__``, then and on every later call. ``close`` stops the
    workers."""

    def __init__(self, dataset: LayoutDataset, batch_size: int, sampler: InfiniteSampler,
                 queue_depth: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._err: Optional[BaseException] = None
        self.num_workers = num_workers if hasattr(os, "fork") else 0
        self._it = iter(sampler)
        self._procs: list = []
        self._stop = threading.Event()
        if self.num_workers > 0:
            self._start_processes(queue_depth)
        else:
            import queue

            self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
            self._thread = threading.Thread(target=self._thread_worker, daemon=True)
            self._thread.start()

    def _next_indices(self) -> list:
        return [next(self._it) for _ in range(self.batch_size)]

    def _thread_worker(self):
        try:
            while not self._stop.is_set():
                self._q.put(self.dataset.collate(self._next_indices()))
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, never lost
            self._q.put(_WorkerError(e))

    def _start_processes(self, queue_depth: int):
        import multiprocessing as mp

        # fork: the workers share the warm sample cache copy-on-write. They
        # only decode and collate numpy; none of them touches CUDA.
        ctx = mp.get_context("fork")
        self._task_q = ctx.Queue(maxsize=self.num_workers * 2 + queue_depth)
        self._result_q = ctx.Queue(maxsize=self.num_workers + queue_depth)
        self._procs = [ctx.Process(target=_process_worker,
                                   args=(self.dataset, self._task_q, self._result_q), daemon=True)
                       for _ in range(self.num_workers)]
        for p in self._procs:
            p.start()
        self._next_seq = 0
        self._reorder: dict = {}
        self._feeder = threading.Thread(target=self._feed_tasks, daemon=True)
        self._feeder.start()

    def _feed_tasks(self):
        seq = 0
        try:
            while True:
                self._task_q.put((seq, self._next_indices()))
                seq += 1
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, never lost
            self._result_q.put((-1, _WorkerError(e)))

    def close(self):
        """Stop the prefetch thread, or terminate the worker processes, and
        wait for them."""
        self._stop.set()
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=10)
        if not self._procs:
            while self._thread.is_alive():  # free a blocked put, then the loop ends
                while not self._q.empty():
                    self._q.get_nowait()
                self._thread.join(timeout=0.1)

    def __iter__(self):
        return self

    def _fail(self, exc: BaseException):
        self._err = exc
        raise RuntimeError("PrefetchLoader worker died while collating a batch") from exc

    def __next__(self) -> dict:
        if self._err is not None:
            raise RuntimeError("PrefetchLoader worker died while collating a batch") from self._err
        if self.num_workers > 0:
            while self._next_seq not in self._reorder:
                seq, item = self._result_q.get()
                if isinstance(item, _WorkerError):
                    self._fail(item.exc)
                self._reorder[seq] = item
            item = self._reorder.pop(self._next_seq)
            self._next_seq += 1
            return item
        item = self._q.get()
        if isinstance(item, _WorkerError):
            self._fail(item.exc)
        return item


def _process_worker(dataset: LayoutDataset, task_q, result_q):
    import signal

    # the parent's handlers are inherited: terminate() must end a worker
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # fresh zip handles: the forked thread-local holds the parent's open
    # file, whose offset the two processes would share
    dataset._local = threading.local()
    while True:
        seq, idxs = task_q.get()
        try:
            result_q.put((seq, dataset.collate(idxs)))
        except Exception as e:  # noqa: BLE001 - handed to the consumer, never lost
            import pickle

            try:
                pickle.dumps(e)
            except Exception:  # an exception the queue cannot carry
                e = RuntimeError(repr(e))
            result_q.put((seq, _WorkerError(e)))


class _WorkerError:
    """Poison pill carrying a prefetch worker's exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc
