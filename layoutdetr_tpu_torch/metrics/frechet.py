"""Fréchet distance between Gaussians fitted to feature sets.

A copy of ``layoutdetr_tpu/metrics/frechet.py``, so that the port imports
nothing of the JAX package. Parity: the pytorch_fid
``calculate_frechet_distance`` the reference calls (metric_layoutnet.py:19,
63), the standard FID formula with scipy's ``sqrtm`` on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2

    prod = sigma1.dot(sigma2)
    if not (np.isfinite(diff).all() and np.isfinite(prod).all()):
        # LAPACK's Schur iteration never ends on NaN/Inf input: never hand
        # sqrtm a non-finite matrix. The FID of non-finite features is
        # undefined; say so and return NaN.
        print("[frechet] WARNING: non-finite feature statistics; returning NaN", flush=True)
        return float("nan")
    covmean = scipy.linalg.sqrtm(prod)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def gaussian_stats(features: np.ndarray):
    """(mean, covariance) of [N, D] features, in float64."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)
