"""Compare pipeline — enhanced vs plain CycleGAN on the same input.

Parity with the GUI's 对比模式 compare tab (gan_login_gui.py:2423-2638):
runs the enhanced model through the local-style "enhanced" post chain with
the tab's fixed detail=0.6, runs the plain CycleGAN model on the same
canvas, and emits original + both results side by side.
"""

from __future__ import annotations

import os

import numpy as np

import jax.numpy as jnp

from ..ops import to_model_range, from_model_range, restore_aspect
from .batch import _decode_canvas, _postprocess
from .model_loader import LoadedModel


def compare_models(enhanced: LoadedModel, cyclegan: LoadedModel, img_path,
                   output_dir, strength: float = 0.8, detail: float = 0.6):
    """Returns dict of output paths {enhanced, cyclegan, figure} (the
    original is shown in the figure, not re-saved)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    canvas, (w, h) = _decode_canvas(img_path, canvas=256, fill=255)
    batch = jnp.asarray(canvas)[None]
    x = to_model_range(batch)

    styled_enh = from_model_range(enhanced.apply(x)) * 255.0
    enh_out = _postprocess(batch.astype(jnp.float32), styled_enh, "enhanced",
                           strength, detail, True, True)[0]
    cyc_out = from_model_range(cyclegan.apply(x))[0] * 255.0

    def finish(arr255, name):
        u8 = np.asarray(jnp.clip(jnp.round(arr255), 0, 255)).astype(np.uint8)
        img = restore_aspect(u8, (w, h), 256)
        p = os.path.join(output_dir, f"compare_{name}.png")
        img.save(p)
        return p, img

    p_enh, img_enh = finish(enh_out, "enhanced")
    p_cyc, img_cyc = finish(cyc_out, "cyclegan")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    orig = Image.open(img_path).convert("RGB")
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, (im, title) in zip(axes, [(orig, "original"),
                                      (img_enh, "enhanced local-style"),
                                      (img_cyc, "cyclegan")]):
        ax.imshow(np.asarray(im))
        ax.set_title(title)
        ax.axis("off")
    figure_path = os.path.join(output_dir, "compare_side_by_side.png")
    fig.tight_layout()
    fig.savefig(figure_path, dpi=110)
    plt.close(fig)
    return {"enhanced": p_enh, "cyclegan": p_cyc, "figure": figure_path}
