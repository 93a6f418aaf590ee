"""Numerical parity of core ops against torch.nn.functional (CPU).

These are the bit-accuracy foundations for the SSIM>=0.99 weight-import
requirement: if conv / conv-transpose / norms match PyTorch here, the
composed models match after weight import.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multi_style_transfer_gan.core import (
    conv2d, conv_transpose2d, linear, instance_norm, batch_norm,
    spectral_normalize, leaky_relu,
)


def _nchw(x_nhwc):
    return np.transpose(x_nhwc, (0, 3, 1, 2))


def _nhwc(x_nchw):
    return np.transpose(x_nchw, (0, 2, 3, 1))


@pytest.mark.parametrize("cin,cout,k,s,p,d", [
    (3, 16, 7, 1, 3, 1),    # enhanced stem
    (16, 32, 4, 2, 1, 1),   # downsample
    (8, 2, 3, 1, 2, 2),     # dilated multiscale branch
    (8, 2, 3, 1, 4, 4),
    (32, 96, 1, 1, 0, 1),   # qkv 1x1
])
def test_conv2d_matches_torch(rng, cin, cout, k, s, p, d):
    x = rng.standard_normal((2, 17, 23, cin), dtype=np.float32)
    w = rng.standard_normal((cout, cin, k, k), dtype=np.float32) * 0.1
    b = rng.standard_normal((cout,), dtype=np.float32)

    ref = F.conv2d(torch.from_numpy(_nchw(x)), torch.from_numpy(w),
                   torch.from_numpy(b), stride=s, padding=p, dilation=d)
    # our kernels are HWIO
    w_hwio = np.transpose(w, (2, 3, 1, 0))
    out = conv2d(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b),
                 stride=s, padding=p, dilation=d)
    np.testing.assert_allclose(np.asarray(out), _nhwc(ref.numpy()),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout,k,s,p", [
    (64, 32, 4, 2, 1),   # enhanced upsample
    (512, 256, 4, 2, 1),  # plain generator decoder (scaled-down channels below)
    (16, 3, 4, 2, 1),
    (8, 4, 3, 2, 1),
])
def test_conv_transpose2d_matches_torch(rng, cin, cout, k, s, p):
    cin, cout = min(cin, 32), min(cout, 32)
    x = rng.standard_normal((2, 9, 13, cin), dtype=np.float32)
    w = rng.standard_normal((cin, cout, k, k), dtype=np.float32) * 0.1  # torch IOHW
    b = rng.standard_normal((cout,), dtype=np.float32)

    ref = F.conv_transpose2d(torch.from_numpy(_nchw(x)), torch.from_numpy(w),
                             torch.from_numpy(b), stride=s, padding=p)
    # importer layout: torch (I, O, kh, kw) -> (kh, kw, I, O)
    w_hwio = np.transpose(w, (2, 3, 0, 1))
    out = conv_transpose2d(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b),
                           stride=s, padding=p)
    np.testing.assert_allclose(np.asarray(out), _nhwc(ref.numpy()),
                               rtol=1e-4, atol=1e-4)


def test_linear_matches_torch(rng):
    x = rng.standard_normal((4, 64), dtype=np.float32)
    w = rng.standard_normal((32, 64), dtype=np.float32)
    b = rng.standard_normal((32,), dtype=np.float32)
    ref = F.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    out = linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_instance_norm_matches_torch(rng):
    x = rng.standard_normal((2, 8, 8, 6), dtype=np.float32)
    ref = F.instance_norm(torch.from_numpy(_nchw(x)))  # affine=False default
    out = instance_norm(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), _nhwc(ref.numpy()),
                               rtol=1e-4, atol=1e-4)


def test_instance_norm_onepass_matches_twopass(rng):
    """E[x^2]-E[x]^2 stats variant: same math as the two-pass form.

    Includes the worst cancellation case (mean >> std): divergence must
    stay at/below one bf16 ulp of the O(1) normalized output."""
    from multi_style_transfer_gan.core.norm import instance_norm_onepass

    # fp32 error model: |d| ~ (mean^2/var) * eps_fp32 * |xhat| — negligible
    # at realistic activation scales, ~3e-2 at the pathological
    # |mean|/std=200 case (which no conv output exhibits).
    for scale, shift, atol in [(1.0, 0.0, 1e-3), (5.0, 3.0, 1e-3),
                               (0.01, -2.0, 6e-2)]:
        x = (rng.standard_normal((2, 16, 16, 8), dtype=np.float32)
             * scale + shift)
        a = np.asarray(instance_norm(jnp.asarray(x)))
        b = np.asarray(instance_norm_onepass(jnp.asarray(x)))
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)
        xb = jnp.asarray(x, jnp.bfloat16)
        a16 = np.asarray(instance_norm(xb), np.float32)
        b16 = np.asarray(instance_norm_onepass(xb), np.float32)
        np.testing.assert_allclose(b16, a16, rtol=0, atol=max(atol, 2e-2))
    # all-zero plane must stay zero (no NaN from var=0)
    z = np.asarray(instance_norm_onepass(jnp.zeros((1, 8, 8, 4))))
    assert np.all(np.isfinite(z)) and np.abs(z).max() == 0.0


def test_in_relu_fused_gradients_match_autodiff(rng):
    """core.norm._in_act's hand-written VJP == XLA autodiff of the
    unfused relu(instance_norm(x)) / leaky_relu(instance_norm(x))."""
    from multi_style_transfer_gan.core import norm as cn

    x = jnp.asarray(rng.standard_normal((2, 12, 12, 6), dtype=np.float32)
                    * 1.7 + 0.4)

    def ref_relu(v):
        return jnp.sum(jnp.sin(jnp.maximum(instance_norm(v), 0) * 3))

    def fused_relu(v):
        return jnp.sum(jnp.sin(cn._in_act(v, 1e-5, 0.0) * 3))

    ga, gb = jax.grad(ref_relu)(x), jax.grad(fused_relu)(x)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ga),
                               rtol=1e-4, atol=1e-5)

    def ref_leaky(v):
        y = instance_norm(v)
        y = jnp.where(y > 0, y, 0.2 * y)
        return jnp.sum(jnp.cos(y) * y)

    def fused_leaky(v):
        y = cn._in_act(v, 1e-5, 0.2)
        return jnp.sum(jnp.cos(y) * y)

    ga, gb = jax.grad(ref_leaky)(x), jax.grad(fused_leaky)(x)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ga),
                               rtol=1e-4, atol=1e-5)


def test_batch_norm_eval_matches_torch(rng):
    c = 6
    x = rng.standard_normal((2, 8, 8, c), dtype=np.float32)
    rm = rng.standard_normal((c,), dtype=np.float32)
    rv = rng.random((c,), dtype=np.float32) + 0.5
    w = rng.standard_normal((c,), dtype=np.float32)
    b = rng.standard_normal((c,), dtype=np.float32)
    ref = F.batch_norm(torch.from_numpy(_nchw(x)), torch.from_numpy(rm),
                       torch.from_numpy(rv), torch.from_numpy(w),
                       torch.from_numpy(b), training=False)
    out, _, _ = batch_norm(jnp.asarray(x), jnp.asarray(rm), jnp.asarray(rv),
                           jnp.asarray(w), jnp.asarray(b), training=False)
    np.testing.assert_allclose(np.asarray(out), _nhwc(ref.numpy()),
                               rtol=1e-4, atol=1e-4)


def test_batch_norm_train_matches_torch(rng):
    c = 6
    x = rng.standard_normal((4, 8, 8, c), dtype=np.float32)
    rm = np.zeros((c,), dtype=np.float32)
    rv = np.ones((c,), dtype=np.float32)
    w = rng.standard_normal((c,), dtype=np.float32)
    b = rng.standard_normal((c,), dtype=np.float32)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    ref = F.batch_norm(torch.from_numpy(_nchw(x)), trm, trv,
                       torch.from_numpy(w), torch.from_numpy(b),
                       training=True, momentum=0.1)
    out, nrm, nrv = batch_norm(jnp.asarray(x), jnp.asarray(rm), jnp.asarray(rv),
                               jnp.asarray(w), jnp.asarray(b), training=True)
    np.testing.assert_allclose(np.asarray(out), _nhwc(ref.numpy()),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(nrm), trm.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(nrv), trv.numpy(), rtol=1e-5, atol=1e-6)


def test_leaky_relu_matches_torch(rng):
    x = rng.standard_normal((128,), dtype=np.float32)
    ref = F.leaky_relu(torch.from_numpy(x), 0.2)
    out = leaky_relu(jnp.asarray(x), 0.2)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), rtol=1e-6)


def test_spectral_norm_matches_torch(rng):
    # torch spectral_norm wraps a Conv2d; after one forward in train mode the
    # effective weight equals weight_orig / sigma with one power iteration.
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    sn = torch.nn.utils.spectral_norm(conv)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8), dtype=np.float32))
    w_orig = sn.weight_orig.detach().numpy().copy()
    u0 = sn.weight_u.detach().numpy().copy()
    sn.train()
    _ = sn(x)  # runs one power iteration, updating weight_u
    w_eff_ref = (sn.weight_orig / torch.einsum(
        "i,ij,j->", sn.weight_u, sn.weight_orig.flatten(1), sn.weight_v
    )).detach().numpy()

    w_hwio = np.transpose(w_orig, (2, 3, 1, 0))
    w_norm, new_u, _ = spectral_normalize(jnp.asarray(w_hwio), jnp.asarray(u0))
    np.testing.assert_allclose(np.asarray(new_u), sn.weight_u.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.transpose(np.asarray(w_norm), (3, 2, 0, 1)),
                               w_eff_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cin,cout,hw", [
    (32, 16, (9, 13)),   # up2 shape family (odd sizes stress the phases)
    (64, 32, (8, 8)),    # up1
    (8, 4, (5, 7)),
])
def test_conv_transpose2d_d2s_matches_transposed_conv(rng, cin, cout, hw):
    """The depth-to-space phase rewrite is math-exact for k=4, s=2, p=1."""
    from multi_style_transfer_gan.core.conv import conv_transpose2d_d2s

    x = rng.standard_normal((2, *hw, cin), dtype=np.float32)
    w = rng.standard_normal((4, 4, cin, cout), dtype=np.float32) * 0.1
    b = rng.standard_normal((cout,), dtype=np.float32)

    ref = conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride=2, padding=1)
    out = conv_transpose2d_d2s(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert out.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], cout)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
