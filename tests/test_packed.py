"""Packed (space-to-depth) execution parity vs the reference NHWC path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multi_style_transfer_gan.core import conv2d, conv_transpose2d, instance_norm
from multi_style_transfer_gan.ops.packed import (
    depth_to_space, space_to_depth,
    pack_conv2d_weight, packed_conv2d,
    pack_conv_transpose2d_weight, packed_conv_transpose2d,
    packed_instance_norm, packed_per_channel_linear,
    packed_window_channel_attention, packed_global_avg_pool,
)


def test_s2d_roundtrip(rng):
    x = jnp.asarray(rng.standard_normal((2, 16, 24, 5)), jnp.float32)
    for f in (2, 4):
        np.testing.assert_array_equal(
            np.asarray(depth_to_space(space_to_depth(x, f), f)), np.asarray(x))


@pytest.mark.parametrize("K,stride,pad,dil,f_in,f_out", [
    (7, 1, 3, 1, 4, 4),   # stem
    (4, 2, 1, 1, 4, 4),   # down1/down2
    (1, 1, 0, 1, 4, 4),   # MSB branch1 / fusion
    (3, 1, 1, 1, 4, 4),   # MSB branch2
    (3, 1, 2, 2, 4, 4),   # MSB branch3
    (3, 1, 4, 4, 4, 4),   # MSB branch4
    (3, 2, 1, 1, 4, 4),   # struct_embed convs
    (7, 1, 3, 1, 4, 4),   # output conv
    (4, 2, 1, 1, 2, 2),   # f=2 variant
    (3, 1, 1, 1, 2, 4),   # mixed factors
    (3, 2, 1, 1, 4, 2),   # stride-2 downsampling pack (needs out_hw crop)
    (3, 2, 1, 1, 2, 1),   # pack -> plain NHWC output
])
def test_pack_conv2d_parity(rng, K, stride, pad, dil, f_in, f_out):
    Cin, Cout, H, W = 3, 5, 32, 48
    x = jnp.asarray(rng.standard_normal((2, H, W, Cin)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((K, K, Cin, Cout)) * 0.2, jnp.float32)
    b = jnp.asarray(rng.standard_normal((Cout,)), jnp.float32)

    ref = conv2d(x, w, b, stride=stride, padding=pad, dilation=dil)
    w_p, b_p, spec = pack_conv2d_weight(w, b, f_in=f_in, f_out=f_out,
                                        stride=stride, padding=pad,
                                        dilation=dil)
    out_hw = (ref.shape[1] // f_out, ref.shape[2] // f_out)
    got = packed_conv2d(space_to_depth(x, f_in), w_p, b_p, spec,
                        out_hw=out_hw)
    got = depth_to_space(got, f_out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,stride,pad,f_in,f_out", [
    (4, 2, 1, 4, 4),   # up1/up2 (packed on both sides)
    (4, 2, 1, 1, 2),   # native in, packed out
    (4, 2, 1, 2, 4),   # mixed
])
def test_pack_conv_transpose2d_parity(rng, K, stride, pad, f_in, f_out):
    Cin, Cout, H, W = 4, 3, 16, 24
    x = jnp.asarray(rng.standard_normal((2, H, W, Cin)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((K, K, Cin, Cout)) * 0.2, jnp.float32)
    b = jnp.asarray(rng.standard_normal((Cout,)), jnp.float32)

    ref = conv_transpose2d(x, w, b, stride=stride, padding=pad)
    w_p, b_p, spec = pack_conv_transpose2d_weight(
        w, b, f_in=f_in, f_out=f_out, stride=stride, padding=pad)
    got = packed_conv_transpose2d(space_to_depth(x, f_in), w_p, b_p, spec,
                                  out_hw=(ref.shape[1] // f_out,
                                          ref.shape[2] // f_out))
    got = depth_to_space(got, f_out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_packed_instance_norm(rng):
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 6)), jnp.float32)
    ref = instance_norm(x)
    got = depth_to_space(packed_instance_norm(space_to_depth(x, 4), 4), 4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_packed_per_channel_linear(rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 6)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((6, 10)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((10,)), jnp.float32)
    ref = conv2d(x, w[None, None], b)  # 1x1 conv
    got = depth_to_space(
        packed_per_channel_linear(space_to_depth(x, 2), w, b, 2), 2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_packed_window_attention(rng):
    from multi_style_transfer_gan.models.enhanced_generator import (
        local_attention_apply, local_attention_init,
    )

    C = 8
    params = local_attention_init(jax.random.PRNGKey(0), C)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, C)), jnp.float32)
    ref = local_attention_apply(params, x, prefix="")
    got = depth_to_space(packed_window_channel_attention(
        space_to_depth(x, 4),
        params["qkv.weight"].reshape(C, 3 * C), params["qkv.bias"],
        params["proj.weight"].reshape(C, C), params["proj.bias"], f=4), 4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_packed_gap(rng):
    x = jnp.asarray(rng.standard_normal((3, 16, 16, 6)), jnp.float32)
    ref = jnp.mean(x, axis=(1, 2))
    got = packed_global_avg_pool(space_to_depth(x, 4), 4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_packed_full_forward_parity(rng):
    """Packed forward == reference forward on the full EnhancedGenerator."""
    from multi_style_transfer_gan.models import (
        enhanced_generator_apply, enhanced_generator_init,
    )
    from multi_style_transfer_gan.models.packed_generator import (
        pack_enhanced_generator_params, packed_enhanced_generator_apply,
    )

    params = enhanced_generator_init(jax.random.PRNGKey(3), channels=4,
                                     num_transformer_blocks=1)
    x = jnp.asarray(np.tanh(rng.standard_normal((2, 64, 96, 3))), jnp.float32)
    ref = enhanced_generator_apply(params, x)
    packed = pack_enhanced_generator_params(params)
    got = jax.jit(packed_enhanced_generator_apply)(packed, x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
