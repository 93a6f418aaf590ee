"""Image-frontend tests: canvas paste vs the reference's PIL recipe."""

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

from multi_style_transfer_gan.ops import (
    canvas_paste, resize_center_crop, aspect_crop_bounds,
    to_model_range, from_model_range,
)


def _pil_canvas(img_u8, canvas=256, fill=255):
    """The reference's exact host recipe (batch_process_images.py:186-200)."""
    im = Image.fromarray(img_u8)
    w, h = im.size
    if w > h:
        nw, nh = canvas, int(h * (canvas / w))
    else:
        nh, nw = canvas, int(w * (canvas / h))
    resized = im.resize((nw, nh), Image.LANCZOS)
    cv = Image.new("RGB", (canvas, canvas), (fill, fill, fill))
    cv.paste(resized, ((canvas - nw) // 2, (canvas - nh) // 2))
    return np.asarray(cv)


@pytest.mark.parametrize("shape", [
    # r5 re-tier (pytest.ini budget): one aspect-ratio case stays in the
    # default tier; the other orientations cost ~4s each and move to slow
    pytest.param((300, 200), marks=pytest.mark.slow),
    pytest.param((180, 320), marks=pytest.mark.slow),
    (256, 256),
])
def test_canvas_paste_close_to_pil(rng, shape):
    img = (rng.random((*shape, 3)) * 255).astype(np.uint8)
    ref = _pil_canvas(img).astype(np.float32) / 255.0

    out, mask = canvas_paste(jnp.asarray(img).astype(jnp.float32) / 255.0,
                             canvas=256, fill=1.0)
    out = np.asarray(out)
    # hard background matches exactly (square sources fill the whole canvas)
    bg = ~np.asarray(mask)[..., 0]
    if bg.any():
        assert np.abs(out[bg] - 1.0).max() < 1e-6
    # interior matches PIL LANCZOS closely (different but compatible
    # resamplers); exclude a 2px boundary ring
    m = np.asarray(mask)[..., 0]
    interior = np.zeros_like(m)
    interior[2:-2, 2:-2] = m[2:-2, 2:-2] & m[:-4, 2:-2] & m[4:, 2:-2] \
        & m[2:-2, :-4] & m[2:-2, 4:]
    diff = np.abs(out - ref)[interior]
    assert diff.mean() < 0.015, diff.mean()
    assert np.quantile(diff, 0.99) < 0.08


@pytest.mark.slow  # r5 re-tier: batched-shape compile only, no oracle
def test_canvas_paste_batched(rng):
    imgs = rng.random((3, 200, 300, 3)).astype(np.float32)
    out, mask = canvas_paste(jnp.asarray(imgs), canvas=128)
    assert out.shape == (3, 128, 128, 3)
    assert mask.shape == (3, 128, 128, 1)


def test_resize_center_crop_square(rng):
    # smooth image: resampler-kernel differences (PIL LANCZOS vs jax
    # lanczos3) decorrelate white noise, so compare on natural-ish content
    yy, xx = np.mgrid[0:300, 0:400] / 100.0
    img = np.stack([np.sin(yy * 2 + xx), np.cos(xx * 3 - yy),
                    np.sin(xx * yy)], -1).astype(np.float32) * 0.5 + 0.5
    img = np.clip(img + rng.random((300, 400, 3)).astype(np.float32) * 0.05,
                  0.0, 1.0)
    out = resize_center_crop(jnp.asarray(img), 256)
    assert out.shape == (256, 256, 3)
    # PIL oracle
    im = Image.fromarray((img * 255).astype(np.uint8))
    w, h = im.size
    # torchvision semantics: short side -> size, long side truncated
    im = im.resize((int(w * 256 / min(w, h)), int(h * 256 / min(w, h))),
                   Image.LANCZOS)
    left = (im.size[0] - 256) // 2
    top = (im.size[1] - 256) // 2
    ref = np.asarray(im.crop((left, top, left + 256, top + 256))) / 255.0
    diff = np.abs(np.asarray(out)[4:-4, 4:-4] - ref[4:-4, 4:-4])
    assert diff.mean() < 0.02, diff.mean()


def test_aspect_crop_bounds():
    # wide image: crop height shrinks (batch_process_images.py:221-227)
    l, t, r, b = aspect_crop_bounds(400, 200, 256)
    assert (r - l, b - t) == (256, 128)
    l, t, r, b = aspect_crop_bounds(200, 400, 256)
    assert (r - l, b - t) == (128, 256)
    assert aspect_crop_bounds(100, 100, 256) == (0, 0, 256, 256)


def test_model_range_roundtrip(rng):
    x = (rng.random((4, 8, 8, 3)) * 255).astype(np.uint8)
    y = to_model_range(jnp.asarray(x))
    assert float(y.min()) >= -1 and float(y.max()) <= 1
    back = from_model_range(y)
    np.testing.assert_allclose(np.asarray(back), x / 255.0, atol=1e-6)


@pytest.mark.slow  # r5 re-tier: the truncation edge case; the square
# oracle (test_resize_center_crop_square) keeps default-tier coverage
def test_resize_center_crop_truncates_long_side(rng):
    # 333x334: long side = int(256*334/333) = 256 (round would give 257,
    # shifting content half a pixel vs torchvision)
    from PIL import Image

    yy, xx = np.mgrid[0:334, 0:333] / 80.0
    img = (np.stack([np.sin(yy + xx), np.cos(xx - yy), np.sin(xx * 0.5)], -1)
           .astype(np.float32) * 0.5 + 0.5)
    out = np.asarray(resize_center_crop(jnp.asarray(img), 256))
    im = Image.fromarray((img * 255).astype(np.uint8))
    w, h = im.size
    im = im.resize((int(w * 256 / min(w, h)), int(h * 256 / min(w, h))),
                   Image.LANCZOS)
    assert im.size == (256, 256)  # the truncation case: no crop needed
    ref = np.asarray(im) / 255.0
    diff = np.abs(out[4:-4, 4:-4] - ref[4:-4, 4:-4])
    assert diff.mean() < 0.02, diff.mean()
