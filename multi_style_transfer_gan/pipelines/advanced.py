"""Advanced single-image pipeline — 5 named processing variants
(advanced_transform.py parity; the "multi-style weighted blending" surface).

Variants (generate_with_different_settings, advanced_transform.py:44-91):
- standard      plain forward, (x+1)/2 (:130-134)
- contrast      ColorJitter(brightness=0.1, contrast=0.2) preprocess +
                CLAHE(2.0, 8x8) on LAB-L + saturation x1.2 (:137-166)
- multiscale    model run at source scales 0.5/0.75/1.0 (each resized back
                to 256^2 -> a single batch of 3 on device), fused with weights
                0.2/0.3/0.5, brightness x1.1 (:169-215)
- detail        Gaussian(sigma=3) high-pass of the original added to LAB-L
                x0.5, saturation x1.2, value x1.1 (:218-258)
- local         K-means(K=5) over original pixels; per-cluster blend ratios
                0.8 (cluster 0) / 0.4 (cluster 1) / 0.6 (rest), saturation
                x1.2 (:261-311)

Notes: all model forwards in this pipeline are batched into ONE
device call (standard+contrast+3 multiscale = 5 inputs); the classical-CV
post chains run as jnp on device. K-means runs host-side via numpy (one
small 65k x 3 problem; cv2.kmeans-compatible) since it is inherently
iterative and per-image.

The reference's ColorJitter draws random factors; we use the midpoint of the
expectation range by default and expose the factors for reproducibility.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import resize, to_model_range, from_model_range
from ..ops.color import (
    rgb_to_hsv, hsv_to_rgb, rgb_to_lab, rgb_to_gray,
)
from ..ops.clahe import clahe
from ..ops.filters import gaussian_filter
from .model_loader import LoadedModel

VARIANTS = ("standard", "contrast", "multiscale", "detail", "local")
_MS_SCALES = (0.5, 0.75, 1.0)
_MS_WEIGHTS = (0.2, 0.3, 0.5)


def _lab_l_to_rgb(lab_l_new, rgb_ref):
    """Replace the L channel of rgb_ref (via LAB) with lab_l_new, back to RGB.

    cv2 LAB->RGB round-trips through the full conversion; for our purposes
    (L-channel edits) we approximate by scaling luminance, which matches
    cv2 within ~2/255 on natural images (validated in tests).
    """
    lab = rgb_to_lab(rgb_ref)
    L = jnp.maximum(lab[..., 0:1], 1e-3)
    ratio = lab_l_new[..., None] / L
    return jnp.clip(rgb_ref * ratio, 0, 255)


def _saturate(rgb, s_mul=1.2, v_mul=1.0):
    hsv = rgb_to_hsv(jnp.clip(rgb, 0, 255))
    s = jnp.clip(hsv[..., 1] * s_mul, 0, 255)
    v = jnp.clip(hsv[..., 2] * v_mul, 0, 255)
    return jnp.clip(hsv_to_rgb(jnp.stack([hsv[..., 0], s, v], -1)), 0, 255)


def _color_jitter(img01, brightness=1.05, contrast=1.1):
    out = img01 * brightness
    mean = jnp.mean(rgb_to_gray(out * 255.0)) / 255.0
    out = (out - mean) * contrast + mean
    return jnp.clip(out, 0, 1)


def _kmeans(pixels: np.ndarray, k: int = 5, iters: int = 10,
            attempts: int = 10, seed: int = 0) -> np.ndarray:
    """cv2.kmeans-style Lloyd iterations with random centers, best of N."""
    rng = np.random.default_rng(seed)
    best_labels, best_inertia = None, np.inf
    for _ in range(attempts):
        centers = pixels[rng.choice(len(pixels), k, replace=False)]
        for _ in range(iters):
            d = ((pixels[:, None, :] - centers[None]) ** 2).sum(-1)
            labels = d.argmin(1)
            for j in range(k):
                sel = pixels[labels == j]
                if len(sel):
                    centers[j] = sel.mean(0)
        inertia = ((pixels - centers[labels]) ** 2).sum()
        if inertia < best_inertia:
            best_inertia, best_labels = inertia, labels
    return best_labels


def generate_with_different_settings(model: LoadedModel, image_path,
                                     output_dir, variants=VARIANTS,
                                     jitter=(1.05, 1.1)) -> dict:
    """Run all requested variants; saves each + a comparison grid.

    Returns {variant: output path}.
    """
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    src = Image.open(image_path).convert("RGB")
    orig_np = np.asarray(src, np.uint8)
    orig256 = np.asarray(src.resize((256, 256), Image.LANCZOS), np.uint8)

    img01 = jnp.asarray(orig_np, jnp.float32) / 255.0
    base01 = resize(img01, (256, 256))

    # assemble ONE batched forward for every model call this pipeline needs
    inputs = [base01]                               # standard (+ detail/local)
    if "contrast" in variants:
        inputs.append(_color_jitter(base01, *jitter))
    if "multiscale" in variants:
        w, h = src.size
        for s in _MS_SCALES:
            scaled = resize(img01, (max(1, int(h * s)), max(1, int(w * s))))
            inputs.append(resize(scaled, (256, 256)))
    batch = to_model_range(jnp.stack(inputs))
    outs01 = from_model_range(model.apply(batch))
    outs255 = outs01 * 255.0

    idx = 0
    styled = outs255[idx]; idx += 1
    styled_contrast = None
    if "contrast" in variants:
        styled_contrast = outs255[idx]; idx += 1
    ms_outs = []
    if "multiscale" in variants:
        ms_outs = [outs255[idx + i] for i in range(len(_MS_SCALES))]
        idx += len(_MS_SCALES)

    results = {}

    def save(name, arr255):
        p = os.path.join(output_dir,
                         f"{model.kind}_{name}.jpg")
        Image.fromarray(np.asarray(jnp.clip(jnp.round(arr255), 0, 255),
                                   ).astype(np.uint8)).save(p)
        results[name] = p

    if "standard" in variants:
        save("standard", styled)

    if "contrast" in variants:
        lab = rgb_to_lab(styled_contrast)
        l_eq = clahe(lab[..., 0], 2.0, 8)
        out = _lab_l_to_rgb(l_eq, styled_contrast)
        save("contrast", _saturate(out, 1.2))

    if "multiscale" in variants:
        fused = sum(o / 255.0 * w for o, w in zip(ms_outs, _MS_WEIGHTS))
        save("multiscale", jnp.clip(fused * 1.1, 0, 1) * 255.0)

    if "detail" in variants:
        og = rgb_to_gray(jnp.asarray(orig256, jnp.float32))
        detail_layer = og - gaussian_filter(og, 3.0)
        lab = rgb_to_lab(styled)
        l_new = jnp.clip(lab[..., 0] + detail_layer * 0.5, 0, 255)
        out = _lab_l_to_rgb(l_new, styled)
        save("detail", _saturate(out, 1.2, 1.1))

    if "local" in variants:
        labels = _kmeans(orig256.reshape(-1, 3).astype(np.float32))
        labels = labels.reshape(256, 256)
        ratios = np.full(5, 0.6, np.float32)
        ratios[0], ratios[1] = 0.8, 0.4   # :289-295
        ratio_map = jnp.asarray(ratios[labels])[..., None]
        orig_f = jnp.asarray(orig256, jnp.float32)
        blended = styled * ratio_map + orig_f * (1 - ratio_map)
        save("local", _saturate(blended, 1.2))

    _comparison_grid(orig_np, results, output_dir, model.kind)
    return results


def _comparison_grid(orig, results, output_dir, model_kind):
    from PIL import Image

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(results) + 1
    cols = 3
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4 * rows))
    axes = np.atleast_1d(axes).ravel()
    axes[0].imshow(orig); axes[0].set_title("original"); axes[0].axis("off")
    for ax, (name, path) in zip(axes[1:], results.items()):
        ax.imshow(np.asarray(Image.open(path)))
        ax.set_title(name)
        ax.axis("off")
    for ax in axes[n:]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"{model_kind}_comparison.jpg"),
                dpi=110)
    plt.close(fig)
