"""FID evaluation harness (m_test.py parity).

Reference flow (m_test.py:81-227): load G_AB/G_BA epoch-200, run up to 100
test images per direction, save side-by-side panels (display processing =
gamma 1.1 + YUV luma histogram equalization, :52-78), extract InceptionV3
pool features, FID via matrix sqrt (:37-50), write test_results.txt with
per-direction + mean FID (:221-225).

Feature extractor: torchvision (and its pretrained InceptionV3) is not
available in this environment and there is no network egress. The extractor
is therefore pluggable:
- pass ``feature_fn`` computing (N, D) features (e.g. a JAX InceptionV3 fed
  from a user-supplied torchvision .pth via
  ``train.perceptual.vgg16_from_torchvision_sd``-style import), or
- fall back to ``default_feature_fn`` — pooled multi-scale image statistics.
  Clearly flagged: fallback FID values are self-consistent (comparable
  between runs of this framework) but NOT comparable to published
  Inception-based FID numbers.
"""

from __future__ import annotations

import os

import numpy as np

import jax.numpy as jnp

from ..data import ImageFolderDataset
from ..ops import to_model_range, from_model_range, resize
from ..ops.color import rgb_to_yuv, yuv_to_rgb
from ..ops.filters import equalize_hist
from .fid import fid_from_features


def display_process(img01):
    """m_test.py:52-78: gamma 1.1 + YUV luma equalization for display."""
    g = jnp.clip(img01, 0, 1) ** (1.0 / 1.1)
    yuv = rgb_to_yuv(g * 255.0)
    yeq = equalize_hist(yuv[..., 0])
    out = yuv_to_rgb(jnp.stack([yeq, yuv[..., 1], yuv[..., 2]], -1))
    return jnp.clip(out, 0, 255) / 255.0


def default_feature_fn(imgs01: jnp.ndarray) -> np.ndarray:
    """Fallback features: multi-scale pooled color/gradient statistics.

    (N, H, W, 3) in [0,1] -> (N, D). NOT Inception features — see module
    docstring.
    """
    feats = []
    x = imgs01.astype(jnp.float32)
    for size in (32, 16, 8):
        r = resize(x, (size, size), method="bilinear")
        feats.append(r.reshape(r.shape[0], -1))
        dx = jnp.diff(r, axis=2).reshape(r.shape[0], -1)
        dy = jnp.diff(r, axis=1).reshape(r.shape[0], -1)
        feats.append(jnp.concatenate([
            jnp.mean(jnp.abs(dx), axis=-1, keepdims=True),
            jnp.mean(jnp.abs(dy), axis=-1, keepdims=True)], -1))
    return np.asarray(jnp.concatenate(feats, axis=-1))


def run_fid_eval(g_ab, g_ba, data_root, output_dir, *, max_images: int = 100,
                 feature_fn=None, batch: int = 16, save_panels: bool = True):
    """Evaluate both directions on the test split; returns FID dict and
    writes test_results.txt (m_test.py:221-225 format)."""
    base_fn = feature_fn or default_feature_fn

    def feature_fn(x01):
        return base_fn(jnp.asarray(np.asarray(x01, np.float32)))

    os.makedirs(output_dir, exist_ok=True)
    results = {}

    for direction, model, src_dom, tgt_dom in (
            ("monet2photo", g_ab, "A", "B"),
            ("photo2monet", g_ba, "B", "A")):
        src = ImageFolderDataset(data_root, src_dom, split="test",
                                 host_size=256)
        tgt = ImageFolderDataset(data_root, tgt_dom, split="test",
                                 host_size=256)
        n = min(len(src), max_images)
        n_t = min(len(tgt), max_images)
        if n < 2 or n_t < 2:
            # np.cov on a single sample is NaN and the Frechet sqrtm blows
            # up — FID needs >= 2 images per side
            print(f"{direction}: need >= 2 test images per domain "
                  f"(have {n}/{n_t}), skipping")
            continue

        fake_feats, real_feats = [], []
        for i in range(0, n, batch):
            imgs = np.stack([src._square(src.load(j))
                             for j in range(i, min(i + batch, n))])
            x = to_model_range(jnp.asarray(imgs))
            fake01 = from_model_range(model.apply(x))
            fake_feats.append(feature_fn(fake01))
            if save_panels and i == 0:
                _save_panels(imgs, fake01, direction, output_dir)
        for i in range(0, n_t, batch):
            imgs = np.stack([tgt._square(tgt.load(j))
                             for j in range(i, min(i + batch, n_t))])
            real_feats.append(feature_fn(jnp.asarray(imgs, jnp.float32) / 255.0))

        fid = fid_from_features(np.concatenate(fake_feats),
                                np.concatenate(real_feats))
        results[direction] = fid
        print(f"{direction}: FID = {fid:.4f} ({n} generated vs {n_t} real)")

    if results:
        mean_fid = float(np.mean(list(results.values())))
        results["mean"] = mean_fid
        with open(os.path.join(output_dir, "test_results.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k} FID: {v:.4f}\n")
    return results


def _save_panels(inputs_u8, outputs01, direction, output_dir, max_panels=4):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    shown = display_process(outputs01[:max_panels])
    fig, axes = plt.subplots(2, max_panels, figsize=(4 * max_panels, 8))
    for i in range(min(max_panels, len(inputs_u8))):
        axes[0, i].imshow(inputs_u8[i]); axes[0, i].axis("off")
        axes[1, i].imshow(np.asarray(shown[i])); axes[1, i].axis("off")
    axes[0, 0].set_title("input")
    axes[1, 0].set_title("generated (display-processed)")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"panels_{direction}.png"), dpi=100)
    plt.close(fig)
