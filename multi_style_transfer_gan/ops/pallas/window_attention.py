"""Fused windowed channel attention for the GPU (Pallas, Triton route).

The op is LocalAttention (``models/enhanced_generator._attention_math``):
1x1 qkv conv, per-token L2 norm over channels, a C x C Gram over the 16
tokens of each 4x4 window, a row softmax, the apply, and the 1x1 output
projection. Its arithmetic intensity is far below the card's ridge point,
so only bytes matter. The XLA formulation writes qkv (3C per pixel) and
two window-major relayouts to device memory; this kernel reads x once and
writes the output once.

One program owns one strip of ``ws`` image rows and a tile of ``nw``
consecutive windows of one image. The input is viewed, with a free
reshape, as (B, H/ws, ws, W/ws, ws, C), so a window is a plain
(ws, ws, C) block of that view. The program loads the weights once, then
loops over its windows; every intermediate stays in registers. All block
dimensions are powers of two, and nothing carries from one program to
the next.

Precision follows ``jax.default_matmul_precision``, as XLA's own
products do. Under "highest" (every reference comparison) float32
products run in IEEE float32 on the CUDA cores; otherwise float32
products run in TF32 on the tensor cores, as XLA runs the reference by
default on the GPU. bfloat16 inputs run the qkv, apply and projection
products on bf16 tensor cores with float32 accumulation; the Gram of the
float32 normalized q and k follows the same rule as float32 products.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Windows per program, at most. More windows amortize the weight loads
# over more work; fewer give more programs to spread over the SMs. On an
# H100 4 to 32 measured within a few per cent of each other at every
# stage shape.
MAX_TILE_WINDOWS = 16


def num_warps(C: int) -> int:
    """Warps per program. One warp holds a 16-token window's products at
    C <= 32 and leaves room for more programs per SM; the C = 64 Gram and
    weights want four (H100 sweep over 1, 2 and 4 at the stage shapes)."""
    return 4 if C >= 64 else 1


def supports(C: int, window_size: int) -> bool:
    """Whether the kernel takes this channel width and window: Triton
    blocks are powers of two, and its products need every dimension of
    the right operand to be at least 16."""
    t = window_size * window_size
    return (C >= 16 and C & (C - 1) == 0
            and t >= 16 and t & (t - 1) == 0)


def tile_windows(n_windows: int) -> int:
    """The largest power of two <= MAX_TILE_WINDOWS dividing the number
    of windows across the width, so the grid tiles the row exactly and no
    padding is needed."""
    nw = 1
    while nw * 2 <= MAX_TILE_WINDOWS and n_windows % (nw * 2) == 0:
        nw *= 2
    return nw


def _exact_products() -> bool:
    """Whether the surrounding ``jax.default_matmul_precision`` asks for
    full float32 products (read at trace time; jit keys on it)."""
    prec = jax.config.jax_default_matmul_precision
    return prec is not None and str(prec).lower() in ("highest", "float32")


def _kernel(x_ref, wq_ref, wk_ref, wv_ref, wp_ref, bq_ref, bk_ref, bv_ref,
            bp_ref, o_ref, *, nw, eps, prec):
    ws, _, _, C = x_ref.shape
    dtype = x_ref.dtype
    exact = dtype == jnp.float32

    def rnd(t):  # round to the activation dtype, as the reference's convs do
        return t if exact else t.astype(dtype).astype(jnp.float32)

    wq, wk, wv, wp = wq_ref[...], wk_ref[...], wv_ref[...], wp_ref[...]
    bq, bk, bv, bp = bq_ref[...], bk_ref[...], bv_ref[...], bp_ref[...]

    def l2n(u):
        n = jnp.sqrt(jnp.sum(u * u, axis=1, keepdims=True))
        return u / jnp.maximum(n, eps)

    def window(j, carry):
        xw = x_ref[:, j, :, :].reshape(ws * ws, C)
        q = rnd(pl.dot(xw, wq, precision=prec) + bq)
        k = rnd(pl.dot(xw, wk, precision=prec) + bk)
        v = (pl.dot(xw, wv, precision=prec) + bv).astype(dtype)
        g = pl.dot(l2n(q), l2n(k), trans_a=True, precision=prec)  # (C, C)
        e = jnp.exp(g - jnp.max(g, axis=1, keepdims=True))
        a = (e / jnp.sum(e, axis=1, keepdims=True)).astype(dtype)
        o = pl.dot(v, a, trans_b=True, precision=prec).astype(dtype)
        o = pl.dot(o, wp, precision=prec) + bp
        o_ref[:, j, :, :] = o.astype(o_ref.dtype).reshape(ws, ws, C)
        return carry

    lax.fori_loop(0, nw, window, 0)


@partial(jax.jit, static_argnames=("window_size", "eps", "interpret"))
def window_channel_attention(x, wqkv, bqkv, wproj, bproj, *,
                             window_size: int = 4, eps: float = 1e-12,
                             interpret: bool = False):
    """LocalAttention on x: (B, H, W, C), H and W divisible by the window.

    Weights are the module's HWIO 1x1 convs: wqkv (1, 1, C, 3C),
    bqkv (3C,), wproj (1, 1, C, C), bproj (C,). Returns x's shape and
    dtype. ``interpret`` runs the kernel in the Pallas interpreter, for
    tests on a machine without a card.
    """
    B, H, W, C = x.shape
    ws = window_size
    if H % ws or W % ws:
        raise ValueError(f"H, W ({H}, {W}) must be divisible by the window "
                         f"size {ws}")
    if not supports(C, ws):
        raise ValueError(f"unsupported channel width {C} / window {ws}")
    nh, nwin = H // ws, W // ws
    nw = tile_windows(nwin)
    w = wqkv.reshape(C, 3 * C).astype(x.dtype)
    wq, wk, wv = w[:, :C], w[:, C:2 * C], w[:, 2 * C:]
    wp = wproj.reshape(C, C).astype(x.dtype)
    b = bqkv.astype(jnp.float32).reshape(3, 1, C)
    bp = bproj.astype(jnp.float32).reshape(1, C)

    win_spec = pl.BlockSpec((None, None, ws, nw, ws, C),
                            lambda b, i, j: (b, i, 0, j, 0, 0))
    w_spec = pl.BlockSpec((C, C), lambda b, i, j: (0, 0))
    b_spec = pl.BlockSpec((1, C), lambda b, i, j: (0, 0))
    out = pl.pallas_call(
        partial(_kernel, nw=nw, eps=eps,
                prec=lax.Precision.HIGHEST if _exact_products() else None),
        out_shape=jax.ShapeDtypeStruct((B, nh, ws, nwin, ws, C), x.dtype),
        grid=(B, nh, nwin // nw),
        in_specs=[win_spec] + [w_spec] * 4 + [b_spec] * 4,
        out_specs=win_spec,
        compiler_params=plt.CompilerParams(num_warps=num_warps(C),
                                           num_stages=1),
        backend="triton",
        interpret=interpret,
        name="window_channel_attention",
    )(x.reshape(B, nh, ws, nwin, ws, C), wq, wk, wv, wp, b[0], b[1], b[2],
      bp)
    return out.reshape(B, H, W, C)
