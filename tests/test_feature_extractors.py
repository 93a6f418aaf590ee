"""Parity tests for the torchvision-weight-compatible feature extractors:
the InceptionV3 FID trunk (metrics/inception.py) and the VGG16 perceptual
trunk (train/perceptual.py), against independent torch functional oracles
fed identical random torchvision-shaped state dicts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feature_oracle import (
    inception_pool_features_torch, make_inception_sd, make_vgg16_sd,
    vgg16_taps_torch,
)


@pytest.fixture(scope="module")
def inception_sd():
    return make_inception_sd(np.random.default_rng(11))


def test_inception_pool_features_parity(inception_sd):
    from multi_style_transfer_gan.metrics.inception import (
        inception_from_torch_sd, inception_pool_features,
    )

    rng = np.random.default_rng(0)
    imgs = rng.random((2, 299, 299, 3)).astype(np.float32)

    params = inception_from_torch_sd(inception_sd)
    got = np.asarray(inception_pool_features(params, jnp.asarray(imgs)))

    want = inception_pool_features_torch(
        inception_sd, torch.tensor(imgs).permute(0, 3, 1, 2)).numpy()

    assert got.shape == (2, 2048)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-3 * scale, (
        np.abs(got - want).max(), scale)


def test_inception_importer_skips_head_keys(inception_sd):
    from multi_style_transfer_gan.metrics.inception import (
        inception_from_torch_sd,
    )

    params = inception_from_torch_sd(inception_sd)
    assert not any(k.startswith(("AuxLogits", "fc."))
                   for k in params)
    assert not any(k.endswith("num_batches_tracked") for k in params)
    # OIHW (32, 3, 3, 3) -> HWIO
    assert params["Conv2d_1a_3x3.conv.weight"].shape == (3, 3, 3, 32)


@pytest.mark.slow
def test_make_inception_feature_fn_end_to_end(inception_sd, tmp_path):
    """.pth on disk -> feature_fn -> FID of a folder pair (resize path +
    harness integration)."""
    from multi_style_transfer_gan.metrics.fid import fid_from_features
    from multi_style_transfer_gan.metrics.inception import (
        make_inception_feature_fn,
    )

    p = tmp_path / "inception_v3.pth"
    torch.save(inception_sd, str(p))
    feature_fn = make_inception_feature_fn(str(p))

    rng = np.random.default_rng(1)
    a = feature_fn(jnp.asarray(rng.random((3, 64, 64, 3)), jnp.float32))
    b = feature_fn(jnp.asarray(rng.random((3, 64, 64, 3)), jnp.float32))
    assert a.shape == (3, 2048) and np.isfinite(a).all()
    fid_same = fid_from_features(np.concatenate([a, a]),
                                 np.concatenate([a, a]))
    fid_diff = fid_from_features(np.concatenate([a, b]),
                                 np.concatenate([b, b]))
    # identical sets: exact FID is 0; sqrtm on a rank-deficient 2048-dim
    # covariance (6 samples) leaves O(1e-2) numerical residue
    assert abs(fid_same) < 0.5
    assert fid_diff > 10 * abs(fid_same)


def test_vgg16_features_parity():
    from multi_style_transfer_gan.train.perceptual import (
        vgg16_features, vgg16_from_torchvision_sd,
    )

    sd = make_vgg16_sd(np.random.default_rng(5))
    rng = np.random.default_rng(2)
    x = (rng.random((2, 64, 64, 3)).astype(np.float32)) * 2.0 - 1.0

    params = vgg16_from_torchvision_sd(sd)
    got = vgg16_features(params, jnp.asarray(x))
    want = vgg16_taps_torch(sd, torch.tensor(x).permute(0, 3, 1, 2))

    assert set(got) == set(want) == {2, 7, 14, 21}
    for idx in got:
        g = np.asarray(got[idx])
        w = want[idx].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        scale = np.abs(w).max() + 1e-8
        assert np.abs(g - w).max() < 1e-3 * scale, (idx, np.abs(g - w).max())


def test_perceptual_and_gram_losses():
    from multi_style_transfer_gan.train.perceptual import (
        gram_matrix, perceptual_loss, vgg16_from_torchvision_sd,
        gram_style_loss,
    )

    sd = make_vgg16_sd(np.random.default_rng(5))
    params = vgg16_from_torchvision_sd(sd)
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.random((1, 32, 32, 3)), jnp.float32) * 2 - 1
    b = jnp.asarray(rng.random((1, 32, 32, 3)), jnp.float32) * 2 - 1

    assert float(perceptual_loss(params, a, a)) == pytest.approx(0.0, abs=1e-6)
    assert float(gram_style_loss(params, a, a)) == pytest.approx(0.0, abs=1e-6)
    assert float(perceptual_loss(params, a, b)) > 0
    assert float(gram_style_loss(params, a, b)) > 0

    f = jnp.asarray(rng.random((2, 8, 8, 4)), jnp.float32)
    g = np.asarray(gram_matrix(f))
    assert g.shape == (2, 4, 4)
    np.testing.assert_allclose(g, np.swapaxes(g, 1, 2), rtol=1e-5)
