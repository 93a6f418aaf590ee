"""GUI local-style blend oracle: ops/gui_effects.py vs a numpy/cv2
transliteration of the reference GUI worker (gan_login_gui.py:1334-1408 —
sky retains original, dilated/blurred Canny edges retain original scaled
by detail, strength/0.3 global ramp only below 0.3)."""

import cv2
import numpy as np
import pytest

import jax.numpy as jnp

from multi_style_transfer_gan.ops.gui_effects import gui_local_style_blend


def _reference_gui_blend(orig_np, styled_np, strength, detail,
                         sky_handling=True, direction="photo2monet"):
    img_np = styled_np.astype(np.float64)
    orig = orig_np.astype(np.float64)
    if sky_handling and direction == "photo2monet":
        hsv = cv2.cvtColor(orig_np.astype(np.uint8), cv2.COLOR_RGB2HSV)
        sky = cv2.inRange(hsv, np.array([90, 30, 140]),
                          np.array([130, 255, 255]))
        upper = np.zeros(orig_np.shape[:2], np.uint8)
        upper[:orig_np.shape[0] // 2] = 255
        sky = cv2.bitwise_and(sky, upper)
        sky = cv2.dilate(sky, np.ones((5, 5), np.uint8), iterations=2)
        sky = cv2.GaussianBlur(sky, (15, 15), 0).astype(float) / 255.0
        img_np = img_np * (1 - sky[..., None]) + orig * sky[..., None]
    gray = cv2.cvtColor(orig_np.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, 50, 150)
    edges = cv2.dilate(edges, np.ones((3, 3), np.uint8), iterations=1)
    ew = cv2.GaussianBlur(edges.astype(float) / 255.0, (21, 21), 0)
    img_np = img_np * (1 - ew[..., None] * detail) + orig * (ew[..., None] * detail)
    if strength < 0.3:
        bf = strength / 0.3
        img_np = img_np * bf + orig * (1 - bf)
    return np.clip(img_np, 0, 255)


@pytest.mark.parametrize("strength", [0.2, 0.6])
@pytest.mark.parametrize("sky", [True, False])
def test_gui_blend_matches_reference(strength, sky):
    rng = np.random.default_rng(1)
    orig = rng.integers(0, 255, (96, 96, 3)).astype(np.float32)
    # blue-sky band in the upper half so the sky path has support
    orig[:30] = np.asarray([100, 140, 220], np.float32)
    orig[45:52, 10:80] = 20.0  # edge structure
    styled = rng.integers(0, 255, (96, 96, 3)).astype(np.float32)

    ours = np.asarray(gui_local_style_blend(
        jnp.asarray(orig)[None], jnp.asarray(styled)[None], strength, 0.6,
        sky_handling=sky, direction="photo2monet"))[0]
    ref = _reference_gui_blend(orig, styled, strength, 0.6, sky_handling=sky)
    diff = np.abs(ours - ref)
    assert diff.mean() < 1.5, diff.mean()
    assert (diff > 4).mean() < 0.03, (diff > 4).mean()


def test_no_global_blend_at_high_strength():
    """strength >= 0.3 applies NO global ramp (the reference's global_blend
    matrix is dead code) — outputs at 0.4 and 0.9 must be identical."""
    rng = np.random.default_rng(2)
    orig = rng.integers(0, 255, (64, 64, 3)).astype(np.float32)
    styled = rng.integers(0, 255, (64, 64, 3)).astype(np.float32)
    a = np.asarray(gui_local_style_blend(jnp.asarray(orig)[None],
                                         jnp.asarray(styled)[None], 0.4, 0.6,
                                         sky_handling=False))
    b = np.asarray(gui_local_style_blend(jnp.asarray(orig)[None],
                                         jnp.asarray(styled)[None], 0.9, 0.6,
                                         sky_handling=False))
    np.testing.assert_array_equal(a, b)


def test_monet2photo_skips_sky():
    """Sky handling is photo2monet-only (gan_login_gui.py:1334)."""
    rng = np.random.default_rng(3)
    orig = rng.integers(0, 255, (64, 64, 3)).astype(np.float32)
    orig[:32] = np.asarray([100, 140, 220], np.float32)
    styled = rng.integers(0, 255, (64, 64, 3)).astype(np.float32)
    with_sky = gui_local_style_blend(jnp.asarray(orig)[None],
                                     jnp.asarray(styled)[None], 0.6, 0.6,
                                     direction="photo2monet")
    no_sky = gui_local_style_blend(jnp.asarray(orig)[None],
                                   jnp.asarray(styled)[None], 0.6, 0.6,
                                   direction="monet2photo")
    assert not np.allclose(np.asarray(with_sky), np.asarray(no_sky))
