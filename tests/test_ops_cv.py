"""Classical-CV op tests against the cv2/scipy oracles the reference uses."""

import numpy as np
import pytest

import jax.numpy as jnp

import cv2
from scipy.ndimage import gaussian_filter as scipy_gauss

from multi_style_transfer_gan.ops.color import (
    rgb_to_gray, rgb_to_hsv, hsv_to_rgb, rgb_to_yuv, yuv_to_rgb, rgb_to_lab,
)
from multi_style_transfer_gan.ops.filters import (
    gaussian_blur, gaussian_filter, sobel, dilate, erode, median_blur3,
    convert_scale_abs, equalize_hist, bilateral_filter, guided_filter, canny,
    box_filter,
)


@pytest.fixture
def img_u8(rng):
    # smooth-ish natural surrogate (avoid pure noise for resampling ops)
    base = rng.random((64, 80, 3)).astype(np.float32)
    base = cv2.GaussianBlur(base, (7, 7), 2.0)
    base = (base - base.min()) / (base.max() - base.min())
    return (base * 255).astype(np.uint8)


def test_rgb_to_gray(img_u8):
    ref = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    got = np.asarray(rgb_to_gray(jnp.asarray(img_u8, jnp.float32)))
    assert np.abs(got - ref).max() <= 1.0  # cv2 rounds to uint8


def test_rgb_hsv_roundtrip(img_u8):
    ref = cv2.cvtColor(img_u8, cv2.COLOR_RGB2HSV).astype(np.float32)
    got = np.asarray(rgb_to_hsv(jnp.asarray(img_u8, jnp.float32)))
    # H wraps at 180; compare circularly
    dh = np.abs(got[..., 0] - ref[..., 0])
    dh = np.minimum(dh, 180 - dh)
    assert dh.max() <= 1.0
    assert np.abs(got[..., 1:] - ref[..., 1:]).max() <= 1.0
    back = np.asarray(hsv_to_rgb(jnp.asarray(got)))
    assert np.abs(back - img_u8.astype(np.float32)).max() <= 1.5


def test_rgb_yuv_roundtrip(img_u8):
    ref = cv2.cvtColor(img_u8, cv2.COLOR_RGB2YUV).astype(np.float32)
    got = np.asarray(rgb_to_yuv(jnp.asarray(img_u8, jnp.float32)))
    assert np.abs(got - ref).max() <= 1.5
    back = np.asarray(yuv_to_rgb(jnp.asarray(got)))
    assert np.abs(back - img_u8.astype(np.float32)).max() <= 2.0


def test_rgb_to_lab(img_u8):
    ref = cv2.cvtColor(img_u8, cv2.COLOR_RGB2LAB).astype(np.float32)
    got = np.asarray(rgb_to_lab(jnp.asarray(img_u8, jnp.float32)))
    assert np.abs(got - ref).max() <= 2.5


def test_gaussian_blur_matches_cv2(img_u8):
    ref = cv2.GaussianBlur(img_u8.astype(np.float32), (7, 7), 0)
    got = np.asarray(gaussian_blur(jnp.asarray(img_u8, jnp.float32), 7))
    assert np.abs(got - ref).max() < 0.05


def test_gaussian_filter_matches_scipy(img_u8):
    g = img_u8[..., 0].astype(np.float64)
    ref = scipy_gauss(g, sigma=2)
    got = np.asarray(gaussian_filter(jnp.asarray(g, jnp.float32), 2.0))
    assert np.abs(got - ref).max() < 0.1


def test_sobel_matches_cv2(img_u8):
    g = img_u8[..., 0].astype(np.float32)
    refx = cv2.Sobel(g, cv2.CV_32F, 1, 0, ksize=3)
    refy = cv2.Sobel(g, cv2.CV_32F, 0, 1, ksize=3)
    gx = np.asarray(sobel(jnp.asarray(g), 0))
    gy = np.asarray(sobel(jnp.asarray(g), 1))
    # interior only (border handling differs at 1px ring)
    assert np.abs(gx - refx)[2:-2, 2:-2].max() < 0.01
    assert np.abs(gy - refy)[2:-2, 2:-2].max() < 0.01


def test_dilate_erode_match_cv2(rng):
    mask = (rng.random((40, 40)) > 0.8).astype(np.uint8)
    k = np.ones((5, 5), np.uint8)
    ref_d = cv2.dilate(mask, k, iterations=2)
    ref_e = cv2.erode(mask, k, iterations=2)
    got_d = np.asarray(dilate(jnp.asarray(mask, jnp.float32), 5, 2))
    got_e = np.asarray(erode(jnp.asarray(mask, jnp.float32), 5, 2))
    # interior (cv2 border constant vs our replicate differs at edges)
    assert (got_d[5:-5, 5:-5] == ref_d[5:-5, 5:-5]).all()
    assert (got_e[5:-5, 5:-5] == ref_e[5:-5, 5:-5]).all()


def test_median_blur3(img_u8):
    g = img_u8[..., 0]
    ref = cv2.medianBlur(g, 3)
    got = np.asarray(median_blur3(jnp.asarray(g, jnp.float32)))
    assert np.abs(got[1:-1, 1:-1] - ref[1:-1, 1:-1].astype(np.float32)).max() == 0


def test_convert_scale_abs(img_u8):
    ref = cv2.convertScaleAbs(img_u8, alpha=1.1, beta=5)
    got = np.asarray(convert_scale_abs(jnp.asarray(img_u8, jnp.float32),
                                       1.1, 5))
    assert np.abs(got - ref.astype(np.float32)).max() <= 1.0


def test_equalize_hist(img_u8):
    g = img_u8[..., 0]
    ref = cv2.equalizeHist(g)
    got = np.asarray(equalize_hist(jnp.asarray(g, jnp.float32)))
    assert np.abs(got - ref.astype(np.float32)).max() <= 1.0


def test_bilateral_close_to_cv2(img_u8):
    f = img_u8.astype(np.float32)
    ref = cv2.bilateralFilter(f, 9, 75, 75)
    got = np.asarray(bilateral_filter(jnp.asarray(f), 9, 75, 75))
    diff = np.abs(got - ref)[4:-4, 4:-4]
    assert diff.mean() < 2.0, diff.mean()


def test_guided_filter_smooths(img_u8):
    f = img_u8.astype(np.float32)
    out = np.asarray(guided_filter(jnp.asarray(f), jnp.asarray(f), 4, 1e-4 * 255 * 255))
    # self-guided filter must smooth but stay close
    assert np.abs(out - f).mean() < 10.0
    tv = lambda x: np.abs(np.diff(x, axis=0)).mean()
    assert tv(out) <= tv(f) + 1e-3


def test_canny_overlap_cv2(img_u8):
    g = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    ref = cv2.Canny(g, 50, 150) > 0
    got = np.asarray(canny(jnp.asarray(g, jnp.float32), 50, 150)) > 0
    # edge maps won't be identical (NMS tie-breaking); require strong overlap
    inter = (ref & got).sum()
    union = (ref | got).sum()
    if union > 0:
        assert inter / union > 0.55, inter / union
    # downstream use blurs the mask (sigma=2, >0.1): compare that mask
    from scipy.ndimage import gaussian_filter as sg
    m_ref = sg(ref.astype(float), sigma=2) > 0.1
    m_got = sg(got.astype(float), sigma=2) > 0.1
    agree = (m_ref == m_got).mean()
    assert agree > 0.9, agree
