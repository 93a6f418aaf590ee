"""Weights bootstrap (scripts/fetch_feature_weights.py) + FID golden tests.

The reference downloads torchvision's pretrained inception_v3 at runtime
(m_test.py:16-34); our bootstrap script converts such a checkpoint offline
into the importer's format. These tests drive the script's offline path with
synthetic torchvision-shaped state dicts and pin the FID statistic against
an independent scipy implementation.
"""

import os
import sys

import numpy as np
import pytest
import torch

from feature_oracle import make_inception_sd, make_vgg16_sd

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import fetch_feature_weights as ffw  # noqa: E402


@pytest.mark.slow  # vgg16 sibling covers the converter in the default tier
def test_fetch_script_converts_inception(tmp_path):
    sd = make_inception_sd(np.random.default_rng(3))
    src = tmp_path / "inception_v3_google-download.pth"
    torch.save(sd, str(src))
    ffw.main(["--model", "inception", "--src", str(src),
              "--out", str(tmp_path), "--no_validate"])
    out = tmp_path / "inception_v3_jax.pth"
    assert out.exists()

    from multi_style_transfer_gan.weights import load_pth
    from multi_style_transfer_gan.metrics.inception import (
        inception_from_torch_sd, inception_pool_features,
    )

    conv = load_pth(str(out))
    # head/aux keys stripped by the converter
    assert not any(k.startswith(("fc.", "AuxLogits")) for k in conv)
    params = inception_from_torch_sd(conv)
    feats = inception_pool_features(
        params, np.random.default_rng(0).random((1, 128, 128, 3), np.float32))
    assert feats.shape == (1, 2048)


def test_fetch_script_converts_vgg16(tmp_path):
    sd = make_vgg16_sd(np.random.default_rng(4))
    src = tmp_path / "vgg16-download.pth"
    torch.save(sd, str(src))
    ffw.main(["--model", "vgg16", "--src", str(src), "--out", str(tmp_path),
              "--no_validate"])
    out = tmp_path / "vgg16_jax.pth"
    assert out.exists()

    from multi_style_transfer_gan.weights import load_pth
    from multi_style_transfer_gan.train.perceptual import (
        vgg16_from_torchvision_sd, vgg16_features,
    )

    import jax.numpy as jnp

    params = vgg16_from_torchvision_sd(load_pth(str(out)))
    taps = vgg16_features(params, jnp.zeros((1, 64, 64, 3)))
    assert len(taps) == 4


@pytest.mark.slow  # full 299^2 inception forwards on CPU
def test_validation_contract_probe_is_deterministic(tmp_path):
    """VERDICT round-2 item 7: the --validate probe numbers (the offline
    contract against a real torchvision run) must be machine-reproducible —
    same synthetic weights, two invocations, identical stats and FID."""
    sd = make_inception_sd(np.random.default_rng(3))
    src = tmp_path / "inception_v3_google-download.pth"
    torch.save(sd, str(src))
    ffw.main(["--model", "inception", "--src", str(src),
              "--out", str(tmp_path), "--no_validate"])

    from multi_style_transfer_gan.metrics.inception import (
        make_inception_feature_fn,
    )

    fn = make_inception_feature_fn(str(tmp_path / "inception_v3_jax.pth"))
    a = ffw.probe_report(fn)
    b = ffw.probe_report(fn)
    assert a == b
    assert a["shape"] == (4, 2048)
    assert np.isfinite(a["probe_fid"]) and a["probe_fid"] >= 0
    # the probe images themselves are part of the contract: pinned stream
    imgs = ffw.probe_images()
    assert imgs.shape == (4, 299, 299, 3)
    assert abs(float(imgs.mean()) - 0.5) < 1e-2


def test_fetch_script_rejects_wrong_checkpoint(tmp_path):
    src = tmp_path / "not_inception.pth"
    torch.save({"foo.weight": torch.zeros(3)}, str(src))
    with pytest.raises(SystemExit, match="does not look like"):
        ffw.main(["--model", "inception", "--src", str(src),
                  "--out", str(tmp_path), "--no_validate"])


# ---------------------------------------------------------------------------
# FID golden: pin our eigh-based sqrtm against scipy's reference sqrtm
# (the reference's exact method, m_test.py:37-50) on fixed features.
# ---------------------------------------------------------------------------

def _fid_scipy(fa, fb):
    from scipy import linalg

    mu1, mu2 = fa.mean(0), fb.mean(0)
    s1 = np.cov(fa, rowvar=False)
    s2 = np.cov(fb, rowvar=False)
    covmean = linalg.sqrtm(s1 @ s2)  # scipy >= 1.16: disp is deprecated
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


def test_fid_matches_scipy_reference():
    from multi_style_transfer_gan.metrics.fid import fid_from_features

    rng = np.random.default_rng(0)
    base = rng.normal(0, 1, (256, 32))
    fa = base + rng.normal(0, 0.1, base.shape)
    fb = base @ rng.normal(0, 0.3, (32, 32)) + rng.normal(1.0, 1.0, (1, 32))
    ours = fid_from_features(fa, fb)
    ref = _fid_scipy(fa, fb)
    assert ours == pytest.approx(ref, rel=1e-4), (ours, ref)


def test_fid_identities():
    from multi_style_transfer_gan.metrics.fid import (
        fid_from_features, frechet_distance,
    )

    rng = np.random.default_rng(1)
    f = rng.normal(0, 1, (128, 16))
    assert fid_from_features(f, f) == pytest.approx(0.0, abs=1e-6)
    # pure mean shift of identical covariances: FID = ||delta mu||^2
    eye = np.eye(4)
    d = frechet_distance(np.zeros(4), eye, np.full(4, 2.0), eye)
    assert d == pytest.approx(16.0, rel=1e-9)


def test_quality_study_synthetic_smoke(tmp_path):
    """The quality-reproduction harness end-to-end on synthetic data:
    stage -> both pipelines -> detailed comparison xlsx -> published diff."""
    import reproduce_quality_study as rqs

    results = rqs.synthetic_smoke(str(tmp_path), canvas=64, n_images=4)
    assert results["n_images"] == 4
    assert os.path.exists(results["xlsx"])
    for model in ("cyclegan", "localstyle"):
        for metric in ("mse", "psnr", "ssim"):
            assert np.isfinite(results[model][metric])
