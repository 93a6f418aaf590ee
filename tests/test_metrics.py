"""Metric-kernel tests: SSIM against a direct numpy transliteration of
skimage's published algorithm (skimage itself is not installed here), PSNR/MSE
against closed forms, FID against scipy's sqrtm, xlsx writer round-trip."""

import io
import zipfile
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import jax.numpy as jnp

from multi_style_transfer_gan.metrics import (
    mse, psnr, ssim, compare_pair, fid_from_features, frechet_distance,
)
from multi_style_transfer_gan.metrics.report import write_xlsx


def _ssim_numpy(a, b, data_range=1.0, win=7, K1=0.01, K2=0.03):
    """Direct transliteration of skimage.metrics.structural_similarity for
    float input, channel_axis=2, gaussian_weights=False."""
    from scipy.ndimage import uniform_filter

    def chan(x, y):
        NP = win * win
        cov_norm = NP / (NP - 1)
        ux = uniform_filter(x, win, mode="constant")
        uy = uniform_filter(y, win, mode="constant")
        uxx = uniform_filter(x * x, win, mode="constant")
        uyy = uniform_filter(y * y, win, mode="constant")
        uxy = uniform_filter(x * y, win, mode="constant")
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        C1 = (K1 * data_range) ** 2
        C2 = (K2 * data_range) ** 2
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
        pad = (win - 1) // 2
        return S[pad:-pad, pad:-pad].mean()

    return np.mean([chan(a[..., c].astype(np.float64),
                         b[..., c].astype(np.float64))
                    for c in range(a.shape[-1])])


def test_ssim_matches_skimage_algorithm(rng):
    a = rng.random((64, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = _ssim_numpy(a, b)
    got = float(ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - ref) < 1e-4, (got, ref)


def test_ssim_identity():
    a = np.random.default_rng(0).random((32, 32, 3)).astype(np.float32)
    assert float(ssim(jnp.asarray(a), jnp.asarray(a))) == pytest.approx(1.0)


def test_psnr_mse(rng):
    a = rng.random((32, 32, 3)).astype(np.float32)
    b = rng.random((32, 32, 3)).astype(np.float32)
    m = float(mse(jnp.asarray(a), jnp.asarray(b)))
    assert m == pytest.approx(np.mean((a - b) ** 2), rel=1e-5)
    p = float(psnr(jnp.asarray(a), jnp.asarray(b)))
    assert p == pytest.approx(10 * np.log10(1.0 / m), rel=1e-5)


def test_compare_pair_batched(rng):
    a = rng.random((4, 32, 32, 3)).astype(np.float32)
    b = rng.random((4, 32, 32, 3)).astype(np.float32)
    out = compare_pair(jnp.asarray(a), jnp.asarray(b))
    assert out["ssim"].shape == (4,)
    assert out["mse"].shape == (4,)


def test_fid_matches_scipy(rng):
    from scipy import linalg

    fa = rng.standard_normal((200, 16))
    fb = rng.standard_normal((200, 16)) + 0.5
    got = fid_from_features(fa, fb)
    mu1, mu2 = fa.mean(0), fb.mean(0)
    s1 = np.cov(fa, rowvar=False)
    s2 = np.cov(fb, rowvar=False)
    covmean = linalg.sqrtm(s1 @ s2).real
    ref = ((mu1 - mu2) @ (mu1 - mu2) + np.trace(s1) + np.trace(s2)
           - 2 * np.trace(covmean))
    assert got == pytest.approx(ref, rel=1e-3)


def test_fid_zero_for_identical(rng):
    f = rng.standard_normal((500, 8))
    assert fid_from_features(f, f) < 1e-4


def test_write_xlsx_roundtrip(tmp_path):
    path = tmp_path / "report.xlsx"
    write_xlsx(path, {
        "Detailed": [["image", "ssim", "psnr"], ["a.jpg", 0.93, 21.5],
                     ["b.jpg", 0.88, 19.0]],
        "Summary": [["metric", "mean"], ["ssim", 0.905]],
    })
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        assert "xl/workbook.xml" in names
        assert "xl/worksheets/sheet1.xml" in names
        sheet = z.read("xl/worksheets/sheet1.xml").decode()
        root = ET.fromstring(sheet)  # valid XML
        assert "0.93" in sheet and "a.jpg" in sheet
        wb = z.read("xl/workbook.xml").decode()
        assert "Detailed" in wb and "Summary" in wb


def test_write_xlsx_numpy_scalars(tmp_path):
    # numpy scalars coerce to real numeric cells (repr(np.float64) under
    # numpy>=2 would otherwise corrupt <v>)
    import zipfile

    path = tmp_path / "np.xlsx"
    write_xlsx(path, {"S": [["a", "b", "c"],
                            [np.float64(3.25), np.float32(1.5), np.int64(7)]]})
    with zipfile.ZipFile(path) as z:
        xml = z.read("xl/worksheets/sheet1.xml").decode()
    assert "<v>3.25</v>" in xml and "<v>7</v>" in xml
    assert "np.float64" not in xml


def test_complete_comparison_no_common_images(tmp_path):
    from multi_style_transfer_gan.metrics.evaluation import (
        complete_comparison,
    )
    from PIL import Image as _Image

    for name, fname in (("orig", "x.png"), ("a", "y.png"), ("b", "z.png")):
        d = tmp_path / name
        d.mkdir()
        _Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(d / fname)
    out = complete_comparison(str(tmp_path / "orig"), str(tmp_path / "a"),
                              str(tmp_path / "b"), output_dir=str(tmp_path))
    assert out["verdict"] == "no matching images to compare"
    assert out["n_images"] == 0


def test_compare_image_quality_same_basename(tmp_path):
    from multi_style_transfer_gan.metrics.evaluation import (
        compare_image_quality,
    )
    from PIL import Image as _Image

    rng = np.random.default_rng(0)
    base = tmp_path / "base"
    base.mkdir()
    img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    _Image.fromarray(img).save(base / "i.png")
    dirs = []
    for parent in ("runA", "runB"):
        d = tmp_path / parent / "output"
        d.mkdir(parents=True)
        _Image.fromarray(np.clip(img + rng.integers(1, 20, img.shape), 0, 255)
                         .astype(np.uint8)).save(d / "i.png")
        dirs.append(str(d))
    out = compare_image_quality(str(base), dirs, output_dir=str(tmp_path))
    assert len(out["results"]) == 2  # both folders reported, not overwritten


@pytest.mark.gpu
def test_ssim_on_gpu_matches_cpu(gpu):
    """The SSIM program compiled for the card agrees with the CPU backend."""
    import jax

    from multi_style_transfer_gan.metrics.quality import ssim

    rng = np.random.default_rng(3)
    a = rng.random((2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    cpu = jax.devices("cpu")[0]
    on_gpu = np.asarray(ssim(jax.device_put(a, gpu), jax.device_put(b, gpu)))
    on_cpu = np.asarray(ssim(jax.device_put(a, cpu), jax.device_put(b, cpu)))
    np.testing.assert_allclose(on_gpu, on_cpu, atol=1e-4, rtol=0)
