"""Single-image transform pipeline (direct_transform.py parity).

CLI surface: ``--image --model --output [--test_sizes] [--test_skip]``.
Preprocess = square Resize((size, size)) + Normalize(0.5) — note the direct
pipeline stretches to a square rather than canvas-pasting
(direct_transform.py:52-59); postprocess = (x+1)/2, clamp, save
(direct_transform.py:66-75).
"""

from __future__ import annotations

import os

import numpy as np

import jax.numpy as jnp

from ..ops import resize, to_model_range, from_model_range
from .model_loader import LoadedModel, load_generator


def _load_rgb(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def _save_rgb(arr01, path):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    # round like torchvision's save_image (mul(255).add_(0.5)) — a plain
    # cast truncates and biases every pixel -0.5 LSB
    img = np.asarray(np.clip(np.round(np.asarray(arr01) * 255.0), 0, 255),
                     np.uint8)
    Image.fromarray(img).save(path)


def transform_image(model: LoadedModel, image_path, output_path=None,
                    size: int = 256, spatial: int = 0):
    """Resize to (size, size), run the generator, return/save [0,1] output.

    Mirrors direct_transform.transform_image:44-79. Returns the HWC float
    array; writes ``output_path`` when given. ``spatial`` > 1 runs the
    forward height-sharded over that many devices (parallel/spatial.py) —
    the high-resolution mode for sizes whose activations outgrow one chip;
    size must be divisible by 16 * spatial.
    """
    img = _load_rgb(image_path)
    x = resize(jnp.asarray(img, jnp.float32) / 255.0, (size, size))
    x = to_model_range(x)[None]
    apply = model.apply
    if spatial and spatial > 1:
        from ..parallel import spatial_apply

        apply = spatial_apply(model, n_devices=spatial)
    y = from_model_range(apply(x))[0]
    if output_path:
        _save_rgb(y, output_path)
    return np.asarray(y)


def test_different_sizes(model: LoadedModel, image_path, output_dir,
                         sizes=(128, 256, 512, 768), spatial: int = 0):
    """Size sweep + comparison grid (direct_transform.py:81-118)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    outs = {}
    for s in sizes:
        out_path = os.path.join(output_dir, f"size_{s}.png")
        outs[s] = transform_image(model, image_path, out_path, size=s,
                                  spatial=spatial)

    fig, axes = plt.subplots(1, len(sizes) + 1,
                             figsize=(4 * (len(sizes) + 1), 4))
    axes[0].imshow(_load_rgb(image_path))
    axes[0].set_title("input")
    axes[0].axis("off")
    for ax, s in zip(axes[1:], sizes):
        ax.imshow(outs[s])
        ax.set_title(f"{s}x{s}")
        ax.axis("off")
    grid_path = os.path.join(output_dir, "size_comparison.png")
    fig.tight_layout()
    fig.savefig(grid_path, dpi=110)
    plt.close(fig)
    return grid_path


def try_skip_connections(model: LoadedModel, image_path, output_dir,
                         blends=(0.5, 0.3, 0.1), size: int = 256,
                         spatial: int = 0):
    """Input-blend ablation (direct_transform.py:120-199): output blended
    with the resized input at the given original-image ratios."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    img = _load_rgb(image_path)
    x01 = resize(jnp.asarray(img, jnp.float32) / 255.0, (size, size))
    apply = model.apply
    if spatial and spatial > 1:
        from ..parallel import spatial_apply

        apply = spatial_apply(model, n_devices=spatial)
    # float32 for host math/plotting: bf16 outputs reach numpy as
    # ml_dtypes bfloat16, which matplotlib rejects
    y01 = np.asarray(from_model_range(apply(to_model_range(x01)[None]))[0],
                     np.float32)

    fig, axes = plt.subplots(1, len(blends) + 2,
                             figsize=(4 * (len(blends) + 2), 4))
    axes[0].imshow(np.asarray(x01)); axes[0].set_title("input"); axes[0].axis("off")
    axes[1].imshow(np.asarray(y01)); axes[1].set_title("output"); axes[1].axis("off")
    results = []
    for ax, alpha in zip(axes[2:], blends):
        blended = np.asarray(x01) * alpha + np.asarray(y01) * (1 - alpha)
        p = os.path.join(output_dir, f"skip_{int(alpha * 100)}.png")
        _save_rgb(blended, p)
        results.append(p)
        ax.imshow(blended)
        ax.set_title(f"{int(alpha * 100)}% original")
        ax.axis("off")
    grid = os.path.join(output_dir, "skip_comparison.png")
    fig.tight_layout(); fig.savefig(grid, dpi=110); plt.close(fig)
    return results
