"""Image-quality metrics: MSE / PSNR / SSIM, batched jnp.

Semantics match the reference's metric kernel (compare_image_quality.py:
14-33, duplicated in three other scripts): images as floats in [0, 1],
``data_range=1.0``, per-channel SSIM averaged over channels
(skimage ``channel_axis=2`` behavior with its default 7x7 uniform window,
gaussian_weights=False, K1=0.01, K2=0.03, and skimage's sample covariance
normalization N/(N-1)).

skimage itself is not installed in this environment; tests validate against
a direct numpy transliteration of the published algorithm and against cv2
where applicable.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def mse(a, b):
    """Mean squared error over all pixels/channels, [0,1] floats."""
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.mean(jnp.square(d), axis=tuple(range(1, d.ndim))) \
        if d.ndim > 3 else jnp.mean(jnp.square(d))


def psnr(a, b, data_range: float = 1.0):
    m = mse(a, b)
    return 10.0 * jnp.log10((data_range ** 2) / m)


def _uniform_filter(x, win: int):
    """skimage-style uniform filter, 'valid' region handled by caller.

    x: (B, H, W, C); returns same-size mean filter with zero padding —
    callers crop the (win//2) border like skimage's crop(pad) step.
    """
    k = jnp.ones((win, win, 1, 1), x.dtype) / (win * win)
    c = x.shape[-1]
    k = jnp.tile(k, (1, 1, 1, c))
    return lax.conv_general_dilated(
        x, k, (1, 1), [(win // 2, win // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c)


def ssim(a, b, data_range: float = 1.0, win_size: int = 7,
         K1: float = 0.01, K2: float = 0.03):
    """Mean SSIM per image, matching skimage.metrics.structural_similarity
    with channel_axis=2 defaults (uniform 7x7 window, unbiased covariances).

    a, b: (H, W, C) or (B, H, W, C) floats in [0, data_range].
    Returns scalar (or (B,) vector) mean SSIM.
    """
    single = a.ndim == 3
    if single:
        a, b = a[None], b[None]
    x = a.astype(jnp.float32)
    y = b.astype(jnp.float32)

    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)  # skimage sample covariance

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux * ux + uy * uy + C1) * (vx + vy + C2))

    pad = (win_size - 1) // 2
    S = S[:, pad:S.shape[1] - pad, pad:S.shape[2] - pad, :]
    out = jnp.mean(S, axis=(1, 2, 3))
    return out[0] if single else out


@partial(jax.jit, static_argnames=("data_range",))
def _compare_pair_jit(a, b, data_range: float = 1.0):
    return {"mse": mse(a, b), "psnr": psnr(a, b, data_range),
            "ssim": ssim(a, b, data_range)}


def compare_pair(a, b, data_range: float = 1.0):
    """The reference's per-pair metric triple (compare_image_quality.py:14-33)."""
    return _compare_pair_jit(a, b, data_range)
