"""The one generator of the benchmark's traffic: banner pages from a seed,
shaped by a mix's parameters (``mixes/<name>.json``).

A mix sets how many distinct pages it draws (``pages``), the elements a
page may hold (``max_elements``, padded to it) and the logo probability
(``logo_p``); a training mix the rows a step takes (``batch``); a serving
mix the layouts a request asks for (``num_results``, one forward over the
page repeated) and the rate requests arrive at (``rate_per_s``). Every
page is drawn from ``numpy.random.default_rng(seed)``: the same seed gives
the same pages, and every seed the same shapes and arrivals.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from benchmark.traffic import grammar, tokenizer

RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class Pages:
    """``n`` pages, each padded to ``max_elements``."""
    backgrounds: torch.Tensor  # uint8 [n, S, S, 3] on the device
    bboxes: np.ndarray  # float32 [n, E, 4] (xc, yc, w, h)
    labels: np.ndarray  # int64 [n, E]
    mask: np.ndarray  # bool [n, E], True on a real element
    texts: List[List[str]]  # [n][E], "" on padding

    def __len__(self) -> int:
        return len(self.texts)

    def label_names(self, i: int) -> List[str]:
        return [grammar.LABELS[k] for k, m in zip(self.labels[i], self.mask[i]) if m]

    def strings(self, i: int) -> List[str]:
        return [t for t, m in zip(self.texts[i], self.mask[i]) if m]


def draw_pages(mix: dict, seed: int, image_size: int, device) -> Pages:
    rng = np.random.default_rng(seed)
    n, e = int(mix["pages"]), int(mix["max_elements"])
    bboxes = np.zeros((n, e, 4), np.float32)
    labels = np.zeros((n, e), np.int64)
    mask = np.zeros((n, e), bool)
    texts, params = [], []
    for i in range(n):
        boxes, labs, strs = grammar.layout(rng, e, float(mix.get("logo_p", 0.6)))
        k = len(boxes)
        bboxes[i, :k], labels[i, :k], mask[i, :k] = boxes, labs, True
        texts.append(strs + [""] * (e - k))
        params.append(grammar.background_params(rng))
    backgrounds = grammar.render_backgrounds(np.stack(params), image_size, device)
    return Pages(backgrounds, bboxes, labels, mask, texts)


def normalize(bg_u8: torch.Tensor) -> torch.Tensor:
    """uint8 pages -> ImageNet-normalized float32, channels last."""
    mean = torch.tensor(RGB_MEAN, device=bg_u8.device)
    std = torch.tensor(RGB_STD, device=bg_u8.device)
    return (bg_u8.float() / 255.0 - mean) / std


class DevicePool:
    """A training mix's pages on the device, uploaded once, and the feed:
    each step takes ``batch`` rows by a permutation drawn from the seed, a
    fresh permutation each pass, so the rows of one pass all differ."""

    def __init__(self, pages: Pages, mix: dict, seed: int, text_len: int, length_clip: int,
                 device):
        ids, tmask, tlen = tokenizer.encode(pages.texts, text_len, length_clip)
        dev = torch.device(device)
        self.arrays = dict(
            bg_u8=pages.backgrounds.to(dev),
            bboxes=torch.from_numpy(pages.bboxes).to(dev),
            labels=torch.from_numpy(pages.labels).to(dev),
            mask=torch.from_numpy(pages.mask).to(dev),
            text_ids=torch.from_numpy(ids.astype(np.int64)).to(dev),
            text_mask=torch.from_numpy(tmask).to(dev),
            text_len=torch.from_numpy(tlen.astype(np.int64)).to(dev))
        self.batch = int(mix["batch"])
        self.device = dev
        self._rng = np.random.default_rng([seed, 1])
        self._order = np.zeros(0, np.int64)

    def next_indices(self) -> np.ndarray:
        if len(self._order) < self.batch:
            self._order = self._rng.permutation(len(self.arrays["labels"]))
        idx, self._order = self._order[:self.batch], self._order[self.batch:]
        return idx

    def gather(self, idx: np.ndarray) -> dict:
        """The train step's batch of rows ``idx``."""
        i = torch.as_tensor(idx)
        if self.device.type == "cuda":
            i = i.pin_memory().to(self.device, non_blocking=True)
        b = {k: v.index_select(0, i) for k, v in self.arrays.items() if k != "bg_u8"}
        b["background"] = normalize(self.arrays["bg_u8"].index_select(0, i))
        return b


class Arrivals:
    """A serving mix's requests in arrival order: request ``k`` arrives
    ``k / rate_per_s`` seconds after the window opens and asks for page
    ``page(k)``, the pages taken in a permutation drawn from the seed, a
    fresh one each pass."""

    def __init__(self, mix: dict, seed: int):
        self.gap = 1.0 / float(mix["rate_per_s"])
        self.n = int(mix["pages"])
        self._rng = np.random.default_rng([seed, 3])
        self._pages: List[int] = []

    def at(self, k: int) -> float:
        return k * self.gap

    def page(self, k: int) -> int:
        while len(self._pages) <= k:
            self._pages += self._rng.permutation(self.n).tolist()
        return self._pages[k]

    def arrived(self, seconds: float) -> int:
        """How many requests have arrived ``seconds`` after the opening."""
        return int(seconds / self.gap) + 1
