"""Image normalization of the data pipeline.

A copy of ``normalize_image``/``denormalize_image`` and the ImageNet
statistics from ``layoutdetr_tpu/data/dataset.py``; the dataset readers
come with the training slice.
"""

from __future__ import annotations

import numpy as np

RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 1, 3)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 1, 3)


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> ImageNet-normalized float32 HWC."""
    return (arr.astype(np.float32) / 255.0 - RGB_MEAN) / RGB_STD


def denormalize_image(arr: np.ndarray) -> np.ndarray:
    """float HWC -> uint8 HWC."""
    x = (arr * RGB_STD + RGB_MEAN) * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)
