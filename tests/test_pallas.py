"""The fused LocalAttention kernel (ops/pallas/window_attention.py).

On the CPU the kernel runs in the Pallas interpreter and is compared with
the XLA formulation it replaces (``_attention_math``); its lowering to
Triton for the GPU is checked without a card. ``gpu``-marked tests need an
NVIDIA GPU and skip elsewhere.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from multi_style_transfer_gan.models.enhanced_generator import (
    _attention_math, enhanced_generator_apply, enhanced_generator_init,
    local_attention_apply,
)
from multi_style_transfer_gan.ops.pallas import window_attention as wa


def _weights(rng, C, scale=0.3):
    return (jnp.asarray(rng.standard_normal((1, 1, C, 3 * C)) * scale,
                        jnp.float32),
            jnp.asarray(rng.standard_normal((3 * C,)) * 0.1, jnp.float32),
            jnp.asarray(rng.standard_normal((1, 1, C, C)) * scale,
                        jnp.float32),
            jnp.asarray(rng.standard_normal((C,)) * 0.1, jnp.float32))


def _reference(x, w):
    with jax.default_matmul_precision("highest"):
        return _attention_math(x.astype(jnp.float32), *w, window_size=4,
                               eps=1e-12)


def _check(got, ref, dtype):
    got = np.asarray(got.astype(jnp.float32))
    ref = np.asarray(ref)
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    else:  # bf16 activations: 2e-2 of the output's scale
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(got - ref).max() <= 2e-2 * scale


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_kernel_matches_reference(rng, C, dtype):
    x = jnp.asarray(rng.standard_normal((2, 8, 16, C)), dtype)
    w = _weights(rng, C)
    got = wa.window_channel_attention(x, *w, interpret=True)
    assert got.shape == x.shape and got.dtype == x.dtype
    _check(got, _reference(x, w), dtype)


@pytest.mark.parametrize("shape", [(1, 4, 12, 16), (1, 12, 4, 32),
                                   (2, 8, 24, 16)],
                         ids=["one-row-3-windows", "one-column",
                              "6-windows-wide"])
def test_kernel_non_square_grids(rng, shape):
    """Window counts that are not powers of two: the tile shrinks to a
    divisor (3 windows -> 1 per program, 6 -> 2) and nothing is padded."""
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    w = _weights(rng, shape[-1])
    _check(wa.window_channel_attention(x, *w, interpret=True),
           _reference(x, w), jnp.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_zero_window(rng, dtype):
    """A window whose q and k are exactly zero (zero input, zero bias):
    the normalize guard gives a zero Gram and a uniform softmax, finite
    like the reference."""
    C = 16
    x = jnp.asarray(rng.standard_normal((1, 8, 8, C)), dtype)
    x = x.at[:, :4, :4, :].set(0)
    wq, bq, wp, bp = _weights(rng, C)
    bq = bq.at[:2 * C].set(0)
    got = wa.window_channel_attention(x, wq, bq, wp, bp, interpret=True)
    assert np.isfinite(np.asarray(got.astype(jnp.float32))).all()
    _check(got, _reference(x, (wq, bq, wp, bp)), dtype)


@pytest.mark.parametrize("n,expected", [(1, 1), (3, 1), (6, 2), (16, 16),
                                        (128, 16)])
def test_tile_windows(n, expected):
    assert wa.tile_windows(n) == expected


@pytest.mark.parametrize("C,ws,ok", [(16, 4, True), (32, 4, True),
                                     (64, 4, True), (48, 4, False),
                                     (8, 4, False), (16, 2, False)])
def test_supports(C, ws, ok):
    assert wa.supports(C, ws) is ok


@pytest.mark.parametrize("C,warps", [(16, 1), (32, 1), (64, 4)])
def test_num_warps(C, warps):
    assert wa.num_warps(C) == warps


@pytest.mark.parametrize("shape,msg", [((1, 6, 8, 16), "divisible"),
                                       ((1, 8, 8, 24), "unsupported")])
def test_kernel_rejects_bad_shapes(rng, shape, msg):
    x = jnp.zeros(shape, jnp.float32)
    with pytest.raises(ValueError, match=msg):
        wa.window_channel_attention(x, *_weights(rng, shape[-1]),
                                    interpret=True)


def _params(rng, C):
    wq, bq, wp, bp = _weights(rng, C)
    return {"a.qkv.weight": wq, "a.qkv.bias": bq, "a.proj.weight": wp,
            "a.proj.bias": bp}


@pytest.mark.parametrize("C", [16, 24], ids=["kernel-width", "other-width"])
def test_fast_attention_off_gpu_is_the_reference(rng, C):
    """fast=True selects the kernel only when lowering for CUDA; on the CPU,
    and for widths the kernel does not take, it is the XLA formulation."""
    x = jnp.asarray(rng.standard_normal((1, 8, 8, C)), jnp.float32)
    params = _params(rng, C)
    fast = jax.jit(lambda p, t: local_attention_apply(p, t, prefix="a.",
                                                      fast=True))(params, x)
    ref = jax.jit(lambda p, t: local_attention_apply(p, t, prefix="a.",
                                                     fast=False))(params, x)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(ref))


@pytest.mark.parametrize("C,dtype", [(16, jnp.bfloat16), (32, jnp.float32),
                                     (64, jnp.bfloat16)])
def test_kernel_lowers_to_triton_for_cuda(C, dtype):
    """The kernel lowers for the GPU without a card: every primitive it
    uses has a Triton lowering rule."""
    x = jax.ShapeDtypeStruct((2, 16, 64, C), dtype)
    w = [jax.ShapeDtypeStruct(s, jnp.float32)
         for s in ((1, 1, C, 3 * C), (3 * C,), (1, 1, C, C), (C,))]
    text = jax.jit(wa.window_channel_attention).trace(x, *w).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "window_channel_attention" in text


def test_generator_lowers_kernel_at_every_stage():
    """The fast forward lowered for CUDA calls the kernel at down1, down2,
    up1 and up2; lowered for the CPU it calls none."""
    params = enhanced_generator_init(jax.random.PRNGKey(0), 16, 1)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.bfloat16)
    fwd = jax.jit(lambda p, t: enhanced_generator_apply(
        p, t, fast_attention=True)).trace(params, x)
    cuda = fwd.lower(lowering_platforms=("cuda",)).as_text()
    cpu = fwd.lower(lowering_platforms=("cpu",)).as_text()
    assert cuda.count("func.call @window_channel_attention") == 4
    assert "xla.gpu.triton" in cuda
    assert "window_channel_attention" not in cpu


@pytest.mark.parametrize("spec", [P("d"), P(None, "d")],
                         ids=["batch-shards", "height-shards"])
def test_sharded_kernel_matches_reference(rng, spec):
    """The kernel per shard under shard_map (the data-parallel and spatial
    paths' wrapper) equals the unsharded reference."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("d",))
    x = jnp.asarray(rng.standard_normal((2, 16, 8, 16)), jnp.float32)
    w = _weights(rng, 16)
    kernel = jax.shard_map(
        lambda *a: wa.window_channel_attention(*a, interpret=True),
        mesh=mesh, in_specs=(spec, P(), P(), P(), P()), out_specs=spec,
        check_vma=False)
    _check(jax.jit(kernel)(x, *w), _reference(x, w), jnp.float32)


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu, rng):
    """Compiled for the card, at a stage width of the deployed model."""
    for C in (16, 32, 64):
        w = _weights(rng, C)
        for dtype in (jnp.float32, jnp.bfloat16):
            x = jax.device_put(jnp.asarray(
                rng.standard_normal((4, 64, 64, C)), dtype), gpu)
            with jax.default_matmul_precision("highest"):
                got = wa.window_channel_attention(x, *w)
            _check(got, _reference(x, w), dtype)
