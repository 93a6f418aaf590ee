"""Native C++ runtime tests (decode/resize/canvas batch, felzenszwalb)."""

import numpy as np
import pytest
from PIL import Image

from multi_style_transfer_gan.native import (
    available, decode_canvas_batch, felzenszwalb_native,
)

pytestmark = pytest.mark.skipif(not available(),
                                reason="native library unavailable")


@pytest.fixture
def structured_img(rng):
    img = np.zeros((120, 160, 3), np.uint8)
    img[:60, :80] = [200, 40, 40]
    img[:60, 80:] = [40, 200, 40]
    img[60:, :] = [40, 40, 200]
    img = np.clip(img.astype(np.int32)
                  + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8)
    return img


def test_decode_canvas_batch_matches_pil(tmp_path, structured_img):
    paths = []
    p = tmp_path / "a.png"
    Image.fromarray(structured_img).save(p)
    paths.append(str(p))
    p2 = tmp_path / "b.jpg"
    Image.fromarray(structured_img[:, :100]).save(p2, quality=95)
    paths.append(str(p2))

    batch, sizes, ok = decode_canvas_batch(paths, 256, 255)
    assert ok.all()
    assert batch.shape == (2, 256, 256, 3)
    assert sizes == [(160, 120), (100, 120)]

    from multi_style_transfer_gan.pipelines.batch import _decode_canvas

    ref, _ = _decode_canvas(paths[0], 256, 255)
    diff = np.abs(batch[0].astype(int) - ref.astype(int))
    # PIL uses int16 fixed-point resampling; ours is double — tiny deltas
    assert diff.mean() < 0.5 and np.quantile(diff, 0.999) <= 4, diff.mean()


def test_decode_fallback_for_bmp(tmp_path, structured_img):
    p = tmp_path / "c.bmp"
    Image.fromarray(structured_img).save(p)
    batch, sizes, ok = decode_canvas_batch([str(p)], 128, 0)
    assert ok.all()  # fell back to PIL
    assert sizes == [(160, 120)]


def test_felzenszwalb_native_matches_python(structured_img):
    from multi_style_transfer_gan.ops.segmentation import (
        _gaussian_smooth, felzenszwalb,
    )

    # python reference path (force fallback by calling internals)
    img = structured_img.astype(np.float64) / 255.0
    sm = _gaussian_smooth(img, 0.5).astype(np.float32)
    lab_c = felzenszwalb_native(sm, 100.0, 50)
    assert lab_c is not None
    # wrapper dispatches to native; partitions must have >= 3 segments
    lab = felzenszwalb(structured_img)
    assert lab.max() + 1 >= 3
    # the three quadrant colors land in different segments
    assert lab[10, 10] != lab[10, 150]
    assert lab[10, 10] != lab[100, 80]


def test_native_lanczos_resize_matches_pil():
    from multi_style_transfer_gan.native import available, lanczos_resize

    if not available():
        import pytest
        pytest.skip("native library unavailable")
    from PIL import Image

    rng = np.random.default_rng(0)
    img = (rng.random((80, 60, 3)) * 255).astype(np.uint8)
    out = lanczos_resize(img, (40, 30))
    ref = np.asarray(Image.fromarray(img).resize((30, 40), Image.LANCZOS))
    assert out.shape == ref.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    # PIL uses int16 fixed-point resampling; ours is double — tiny deltas
    assert diff.mean() < 0.5 and np.quantile(diff, 0.999) <= 5, diff.mean()


def test_native_save_canvas_batch_matches_pil(tmp_path, structured_img, rng):
    """Native save = aspect-crop + resize-back + encode (restore_aspect
    semantics, batch_process_images.py:412-438)."""
    from multi_style_transfer_gan.native import save_canvas_batch
    from multi_style_transfer_gan.ops import restore_aspect

    # smooth gradients: JPEG loss (esp. 4:2:0 chroma) stays small, so the
    # comparison isolates the crop/resize geometry, not codec noise
    g = np.linspace(0, 255, 256)
    styled = np.stack([np.stack([
        np.add.outer(g * s, g * (1 - s)) / 2 + 40 * s for s in (0.2, 0.5, 0.8)
    ], -1)] * 3).astype(np.uint8)
    styled += (rng.integers(0, 3, styled.shape)).astype(np.uint8)
    sizes = [(320, 240), (240, 320), (2048, 1536)]  # last one >1MP: crop only
    paths = [str(tmp_path / f"out_{i}.png") for i in range(2)] + [
        str(tmp_path / "out_2.jpg")]
    ok = save_canvas_batch(styled, sizes, paths)
    assert ok is not None and ok.all()
    for i, (p, wh) in enumerate(zip(paths, sizes)):
        got = np.asarray(Image.open(p).convert("RGB"))
        ref = np.asarray(restore_aspect(styled[i], wh, 256))
        assert got.shape == ref.shape
        diff = np.abs(got.astype(int) - ref.astype(int))
        tol = 1.0 if p.endswith(".png") else 6.0  # JPEG is lossy
        assert diff.mean() < tol, (p, diff.mean())


def test_native_save_unknown_extension_falls_back(tmp_path, rng):
    from multi_style_transfer_gan.native import save_canvas_batch

    styled = rng.integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    ok = save_canvas_batch(styled, [(128, 128)], [str(tmp_path / "x.bmp")])
    assert ok is not None and not ok.any()  # caller must PIL-fallback


def test_scaled_jpeg_decode_close_to_full(tmp_path, rng):
    """DCT-scaled decode (PIL draft strategy) must stay visually equivalent
    to the full-decode + Lanczos reference for large downscales."""
    img = np.clip(
        np.linspace(0, 255, 512)[None, :, None]
        + np.linspace(0, 80, 640)[:, None, None]
        + rng.normal(0, 10, (640, 512, 3)), 0, 255).astype(np.uint8)
    p = tmp_path / "big.jpg"
    Image.fromarray(img).save(p, quality=92)

    batch, sizes, ok = decode_canvas_batch([str(p)], 256, 255)
    assert ok.all() and sizes == [(512, 640)]

    from multi_style_transfer_gan.pipelines.batch import _decode_canvas

    ref, _ = _decode_canvas(str(p), 256, 255)
    diff = np.abs(batch[0].astype(int) - ref.astype(int))
    # 8x8-block DCT prescale + Lanczos vs pure Lanczos: small but nonzero
    assert diff.mean() < 2.0 and np.quantile(diff, 0.99) <= 12, (
        diff.mean(), np.quantile(diff, 0.99))
