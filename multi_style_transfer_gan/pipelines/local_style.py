"""Region-adaptive local style transfer (enhanced_local_style.py parity).

Flow (enhanced_local_style_transfer, :178-292): aspect-preserving resize onto
a BLACK 256^2 canvas -> generator forward -> felzenszwalb segmentation
(scale=100, sigma=0.5, min_size=50; slic/quickshift selectable, :56-74) ->
per-segment statistics (mean RGB/HSV, color std, Sobel edge density over the
masked image, size, centroid — :76-124) -> per-segment blend ratio
0.7 + edge + colorvar - position + size + saturation adjustments clamped to
[0.3, 0.9] (:126-176) -> Gaussian(sigma=3)-smoothed blend map -> blend ->
saturation x1.2 + CLAHE(2.0, 8x8) on V + 3x3 sharpen kernel + bilateral
(5, 50, 50) denoise (:242-264) -> aspect crop/restore -> save + 4-panel
comparison figure (:294-321).

Split: segmentation runs host-side (irregular, iterative); everything
dense — the model forward, per-segment Sobel batch, blend, color chain —
runs as jnp on device. One deliberate deviation: the reference's final
aspect-crop formula (:270-277) mis-sizes the crop box for sources smaller
than 256px (it clamps with the *original* dimensions); we crop with the
same geometry used to paste (ops.aspect_crop_bounds), which is what its
batch pipeline does (batch_process_images.py:412-434).
"""

from __future__ import annotations

import os

import numpy as np

import jax.numpy as jnp

from ..ops import to_model_range, from_model_range, aspect_crop_bounds
from ..ops.color import rgb_to_hsv, hsv_to_rgb, rgb_to_gray
from ..ops.clahe import clahe
from ..ops.filters import (
    sobel, gaussian_filter, filter2d, bilateral_filter,
)
from ..ops.segmentation import felzenszwalb, slic, quickshift
from .batch import _decode_canvas
from .model_loader import LoadedModel

_SHARPEN = np.asarray([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)


def get_segmentation_mask(img_np: np.ndarray, method: str = "felzenszwalb",
                          n_segments: int = 100, compactness: float = 10.0):
    """Method dispatch matching enhanced_local_style.py:56-74."""
    if method == "slic":
        return slic(img_np, n_segments=n_segments, compactness=compactness)
    if method == "felzenszwalb":
        return felzenszwalb(img_np, scale=100, sigma=0.5, min_size=50)
    if method == "quickshift":
        return quickshift(img_np, kernel_size=3, max_dist=6, ratio=0.5)
    raise ValueError(f"unknown segmentation method: {method}")


def analyze_segments(img_np: np.ndarray, segments: np.ndarray) -> dict:
    """Per-segment stats (:76-124), vectorized.

    Edge density replicates the reference exactly: Sobel magnitude of the
    image with everything outside the segment zeroed, averaged over the
    WHOLE frame (:102-110) — computed for all segments in one batched
    device Sobel.
    """
    # cv2-convention HSV from our own op — keeps the default felzenszwalb
    # path opencv-free
    hsv = np.asarray(rgb_to_hsv(jnp.asarray(img_np, jnp.float32)))
    seg_ids = np.unique(segments)
    n = len(seg_ids)
    flat = segments.ravel()
    remap = np.searchsorted(seg_ids, flat)
    counts = np.bincount(remap, minlength=n).astype(np.float64)

    def seg_mean(channel):
        return np.bincount(remap, channel.ravel().astype(np.float64),
                           minlength=n) / counts

    rgb_mean = np.stack([seg_mean(img_np[..., c]) for c in range(3)], 1)
    hsv_mean = np.stack([seg_mean(hsv[..., c]) for c in range(3)], 1)
    sq_mean = np.stack([seg_mean(img_np[..., c].astype(np.float64) ** 2)
                        for c in range(3)], 1)
    std = np.sqrt(np.maximum(sq_mean - rgb_mean ** 2, 0))

    ys, xs = np.mgrid[0:segments.shape[0], 0:segments.shape[1]]
    pos = np.stack([seg_mean(ys), seg_mean(xs)], 1)

    # batched masked-image Sobel on device
    masks = (remap.reshape(segments.shape)[None] ==
             np.arange(n)[:, None, None])
    gray_masked = []
    for c in range(0, n, 32):  # chunk to bound memory
        chunk = masks[c:c + 32][..., None] * img_np[None]
        g = rgb_to_gray(jnp.asarray(chunk, jnp.float32))
        gx = sobel(g[..., None], 0)[..., 0]
        gy = sobel(g[..., None], 1)[..., 0]
        mag = jnp.sqrt(gx * gx + gy * gy)
        gray_masked.append(np.asarray(jnp.mean(mag, axis=(1, 2))))
    edge_density = np.concatenate(gray_masked)

    return {
        int(sid): {
            "avg_color_rgb": rgb_mean[i], "avg_color_hsv": hsv_mean[i],
            "std_color": std[i], "edge_density": float(edge_density[i]),
            "size": int(counts[i]), "position": pos[i],
        }
        for i, sid in enumerate(seg_ids)
    }


def determine_blend_ratios(segment_stats: dict, segments: np.ndarray,
                           img_shape) -> np.ndarray:
    """Per-segment blend ratio (:126-176). One per-segment scalar pass +
    a single vectorized lookup (no per-segment full-frame masks)."""
    cy, cx = img_shape[0] // 2, img_shape[1] // 2
    max_dist = np.sqrt(cx ** 2 + cy ** 2)
    seg_ids = np.unique(segments)
    ratios = np.empty(len(seg_ids), np.float32)
    for i, sid in enumerate(seg_ids):
        st = segment_stats[int(sid)]
        edge_factor = 0.3 * (st["edge_density"] / 30)
        color_var = 0.2 * (np.mean(st["std_color"]) / 50)
        py, px = st["position"]
        dist = np.sqrt((py - cy) ** 2 + (px - cx) ** 2)
        dist_factor = 0.1 * (dist / max_dist)
        size_factor = -0.1 * (st["size"] /
                              (img_shape[0] * img_shape[1] / 100))
        sat_factor = 0.2 * (st["avg_color_hsv"][1] / 255)
        ratio = 0.7 + edge_factor + color_var - dist_factor \
            + size_factor + sat_factor
        ratios[i] = max(0.3, min(0.9, ratio))
    blend_map = ratios[np.searchsorted(seg_ids, segments)]
    return np.asarray(gaussian_filter(jnp.asarray(blend_map), 3.0))


def enhanced_local_style_transfer(model: LoadedModel, img_path, output_path,
                                  method: str = "felzenszwalb",
                                  make_comparison: bool = True):
    """Full pipeline; returns the final PIL image."""
    from PIL import Image

    src = Image.open(img_path).convert("RGB")
    width, height = src.size
    canvas, _ = _decode_canvas(img_path, canvas=256, fill=0)  # black canvas

    x = to_model_range(jnp.asarray(canvas))[None]
    styled01 = from_model_range(model.apply(x))[0]
    styled = np.asarray(jnp.clip(jnp.round(styled01 * 255.0), 0, 255)
                        ).astype(np.uint8)

    segments = get_segmentation_mask(canvas, method=method)
    stats = analyze_segments(canvas, segments)
    blend_map = determine_blend_ratios(stats, segments, canvas.shape)

    bm = jnp.asarray(blend_map)[..., None]
    blended = jnp.asarray(styled, jnp.float32) * bm \
        + jnp.asarray(canvas, jnp.float32) * (1 - bm)
    blended = jnp.clip(jnp.round(blended), 0, 255)

    # color chain (:242-264)
    hsv = rgb_to_hsv(blended)
    s = jnp.clip(hsv[..., 1] * 1.2, 0, 255)
    v = clahe(hsv[..., 2], 2.0, 8)
    enhanced = jnp.clip(hsv_to_rgb(jnp.stack([hsv[..., 0], s, v], -1)),
                        0, 255)
    sharpened = jnp.clip(filter2d(enhanced, _SHARPEN), 0, 255)
    final = bilateral_filter(sharpened, 5, 50, 50)
    final_np = np.asarray(jnp.clip(jnp.round(final), 0, 255)).astype(np.uint8)

    out = Image.fromarray(final_np)
    l, t, r, b = aspect_crop_bounds(width, height, 256)
    if (l, t, r, b) != (0, 0, 256, 256):
        out = out.crop((l, t, r, b))
    # reference-faithful guard (enhanced_local_style.py:280-281): sources
    # SMALLER than the canvas keep their crop size — unlike the batch
    # pipeline's restore, which resizes whenever <=1MP
    if (width > 256 or height > 256) and width * height <= 1024 * 1024:
        out = out.resize((width, height), Image.LANCZOS)

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    out.save(output_path)

    if make_comparison:
        _comparison(canvas, styled, blend_map, out,
                    os.path.join(os.path.dirname(os.path.abspath(output_path)),
                                 "comparison.jpg"))
    return out


def _comparison(original, stylized, blend_map, final, path):
    """4-panel figure (:294-321)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    axes[0, 0].imshow(original); axes[0, 0].set_title("original")
    axes[0, 1].imshow(stylized); axes[0, 1].set_title("stylized")
    im = axes[1, 0].imshow(blend_map, cmap="viridis", vmin=0, vmax=1)
    axes[1, 0].set_title("blend map")
    fig.colorbar(im, ax=axes[1, 0])
    axes[1, 1].imshow(np.asarray(final)); axes[1, 1].set_title("final")
    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
