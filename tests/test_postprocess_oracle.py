"""Composed postprocess oracle: the batch pipeline's device-side 'enhanced'
branch vs a direct numpy/cv2/scipy transliteration of the reference
(batch_process_images.py:312-350 + detect_sky:126-150 +
smooth_transitions:152-174).

test_ops_cv.py validates each op against cv2 individually; this test guards
the COMPOSITION — mask order (sky first, detail overrides), the per-image
has-sky gate, the weight formulas, and the enhance/smooth chain — end to
end on both a sky-dominant and a no-sky image.
"""

import cv2
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter as nd_gaussian

import jax.numpy as jnp

from multi_style_transfer_gan.pipelines.batch import _postprocess


def _reference_enhanced(original_np, styled_np, strength, detail,
                        enhance_colors, smooth):
    """Transliteration of the reference's enhanced branch (float in/out)."""
    img_hsv = cv2.cvtColor(original_np.astype(np.uint8), cv2.COLOR_RGB2HSV)
    h, s, v = cv2.split(img_hsv)
    sky_mask = (v > 150) & (s < 100)
    has_sky = sky_mask.sum() / (original_np.shape[0] * original_np.shape[1]) > 0.7

    gray = cv2.cvtColor(original_np.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, 50, 150)
    detail_mask = nd_gaussian((edges > 0).astype(float), sigma=2) > 0.1

    weight = np.ones_like(gray, dtype=float) * strength
    if has_sky:
        weight[sky_mask] = min(strength + 0.2, 1.0)
    weight[detail_mask] = max(strength - 0.3 * detail, 0.0)
    result = original_np * (1 - weight[..., None]) + styled_np * weight[..., None]

    if enhance_colors:
        result = cv2.convertScaleAbs(result, alpha=1.1, beta=5).astype(float)
    if smooth:
        kernel = np.ones((5, 5), np.uint8)
        dilated = cv2.dilate(detail_mask.astype(np.uint8), kernel, iterations=2)
        eroded = cv2.erode(detail_mask.astype(np.uint8), kernel, iterations=2)
        boundary = (dilated - eroded) > 0
        blurred = cv2.GaussianBlur(result.astype(np.uint8), (7, 7), 0)
        result = result.copy()
        result[boundary] = result[boundary] * 0.5 + blurred[boundary] * 0.5
    return np.clip(result, 0, 255)


def _images(sky: bool, seed=0):
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 255, (96, 96, 3)).astype(np.float32)
    if sky:
        # >70% bright low-saturation pixels (the has-sky gate) + structure
        base = np.full((96, 96, 3), 220.0, np.float32)
        base += rng.normal(0, 6, base.shape).astype(np.float32)
        base[80:] = canvas[80:]
        base[40:48, 20:70] = 30.0  # a dark bar for Canny edges
        canvas = np.clip(base, 0, 255)
    styled = rng.integers(0, 255, (96, 96, 3)).astype(np.float32)
    return canvas, styled


@pytest.mark.parametrize("sky", [True, False])
@pytest.mark.parametrize("enhance,smooth", [(True, True), (False, False)])
def test_enhanced_branch_matches_reference_transliteration(sky, enhance,
                                                           smooth):
    canvas, styled = _images(sky)
    ours = np.asarray(_postprocess(jnp.asarray(canvas)[None],
                                   jnp.asarray(styled)[None], "enhanced",
                                   0.8, 0.7, enhance, smooth))[0]
    ref = _reference_enhanced(canvas, styled, 0.8, 0.7, enhance, smooth)
    diff = np.abs(ours - ref)
    # mask-boundary pixels may flip between the cv2/scipy oracle and the
    # device ops (both op-level parity-tested); the field must agree
    assert diff.mean() < 1.5, diff.mean()
    assert (diff > 3).mean() < 0.03, (diff > 3).mean()


def test_sky_gate_boosts_sky_weight():
    """On a sky-dominant canvas, pure-sky pixels (no edges nearby) must
    blend at weight min(strength+0.2, 1) = 0.7, NOT the base 0.5 — this
    fails if the has-sky fraction gate (>0.7) or the boost breaks."""
    canvas, styled = _images(sky=True)
    out = np.asarray(_postprocess(jnp.asarray(canvas)[None],
                                  jnp.asarray(styled)[None], "enhanced",
                                  0.5, 0.7, False, False))[0]
    region = np.s_[2:12, 2:12]  # sky, far from the Canny bar at rows 40-48
    expected = canvas[region] * (1 - 0.7) + styled[region] * 0.7
    np.testing.assert_allclose(out[region], expected, atol=1.0)
    base_blend = canvas[region] * (1 - 0.5) + styled[region] * 0.5
    assert np.abs(out[region] - base_blend).mean() > 1.0  # gate really fired
