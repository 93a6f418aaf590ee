"""Convolution primitives with PyTorch-compatible semantics on NHWC data.

Design notes:
- Activations are NHWC (channels-last), the layout cuDNN's tensor-core
  convolutions take without relayout copies.
- Kernels are HWIO. PyTorch checkpoints store OIHW (Conv2d) / IOHW
  (ConvTranspose2d); `weights.torch_import` transposes once at load time.
- All convs lower to `lax.conv_general_dilated`, which XLA hands to its
  convolution libraries and fuses with surrounding elementwise ops
  (norm/activation).

Numerical parity targets (verified in tests/test_core_parity.py against
torch.nn.functional): `nn.Conv2d(k, s, p)` and `nn.ConvTranspose2d(k, s, p)`
as used in the reference models (reference: enhanced_generator.py:92-139,
pretrain.py:60-97).
"""

from __future__ import annotations


import jax.numpy as jnp
from jax import lax

# NHWC activations, HWIO kernels.
_DIMNUMS = ("NHWC", "HWIO", "NHWC")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _accum_dtype(x, preferred_dtype):
    """Conv output/accumulator dtype. bf16 tensor-core convs accumulate in
    fp32 internally; requesting an fp32 OUTPUT from a bf16 conv breaks the
    kernel-gradient transpose rule (lax transpose_rhs requires matching
    operand dtypes), so under mixed precision the conv emits the input
    dtype — the standard mixed-precision trade. fp32 inputs are
    unaffected."""
    return preferred_dtype if x.dtype == jnp.float32 else x.dtype


def conv2d(x, w, b=None, *, stride=1, padding=0, dilation=1,
           preferred_dtype=jnp.float32):
    """2-D convolution matching ``torch.nn.functional.conv2d``.

    Args:
      x: (B, H, W, Cin) input.
      w: (kh, kw, Cin, Cout) kernel (HWIO).
      b: optional (Cout,) bias.
      stride / padding / dilation: int or (int, int), symmetric padding —
        exactly PyTorch's Conv2d semantics.
      preferred_dtype: requested output/accumulator dtype for fp32 inputs.
        For non-fp32 inputs the conv emits the input dtype instead (see
        _accum_dtype).
    """
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    out = lax.conv_general_dilated(
        x, w.astype(x.dtype),
        window_strides=s,
        padding=[(p[0], p[0]), (p[1], p[1])],
        rhs_dilation=d,
        dimension_numbers=_DIMNUMS,
        preferred_element_type=_accum_dtype(x, preferred_dtype),
    )
    out = out.astype(x.dtype)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out


def conv_transpose2d(x, w, b=None, *, stride=1, padding=0, output_padding=0,
                     dilation=1, preferred_dtype=jnp.float32):
    """2-D transposed convolution matching ``torch.nn.functional.conv_transpose2d``.

    PyTorch's ConvTranspose2d(k, s, p) with output size (H-1)*s - 2p + k is
    implemented the XLA way: a regular convolution over an lhs-dilated input
    with the kernel flipped spatially. For torch parity the weight passed here
    must already be in HWIO with I=Cin of *this* op's input (i.e. the torch
    IOHW weight transposed by the importer; no flipping here — we flip below).

    Args:
      x: (B, H, W, Cin).
      w: (kh, kw, Cin, Cout) — torch's (Cin, Cout, kh, kw) transposed to HWIO.
      b: optional (Cout,).
    """
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    op = _pair(output_padding)
    kh = (w.shape[0] - 1) * d[0] + 1
    kw = (w.shape[1] - 1) * d[1] + 1
    # Flip spatially: transposed conv correlates with the reversed kernel.
    w = w[::-1, ::-1, :, :]
    pad_h = (kh - 1 - p[0], kh - 1 - p[0] + op[0])
    pad_w = (kw - 1 - p[1], kw - 1 - p[1] + op[1])
    out = lax.conv_general_dilated(
        x, w.astype(x.dtype),
        window_strides=(1, 1),
        padding=[pad_h, pad_w],
        lhs_dilation=s,
        rhs_dilation=d,
        dimension_numbers=_DIMNUMS,
        preferred_element_type=_accum_dtype(x, preferred_dtype),
    )
    out = out.astype(x.dtype)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out


def _convt_k4s2p1_phase_kernel(w):
    """Rewrites a (4, 4, Cin, Cout) ConvTranspose2d(k=4, s=2, p=1) weight as
    a (3, 3, Cin, 4*Cout) regular-conv kernel computing the four output
    phases (depth-to-space trick).

    Transposed-conv law per dim: out[2*i - 1 + t] += x[i] * W[t], t in [0,4).
    Solving for each output phase:
      even  out[2u]   = x[u-1]*W[3] + x[u]*W[1]
      odd   out[2u+1] = x[u]*W[2]   + x[u+1]*W[0]
    Both supports fit one 3x3 window centered at u (padding 1); the kernel
    below places each phase's two taps per dim and zeros elsewhere. Adding
    exact zeros keeps the math identical to the transposed conv (same
    products, reassociated sums).
    """
    if w.shape[:2] != (4, 4):
        raise ValueError(
            f"conv_transpose2d_d2s only rewrites 4x4 stride-2 pad-1 kernels; "
            f"got spatial shape {tuple(w.shape[:2])}")
    cin, cout = w.shape[2], w.shape[3]
    # per-dim map: (phase d, 3-window tap position) -> source tap t of w
    sel = ((0, 0, 3), (0, 1, 1), (1, 1, 2), (1, 2, 0))
    k = jnp.zeros((3, 3, cin, 4 * cout), w.dtype)
    for dy, wy, ty in sel:
        for dx, wx, tx in sel:
            ph = dy * 2 + dx
            k = k.at[wy, wx, :, ph * cout:(ph + 1) * cout].set(w[ty, tx])
    return k


def conv_transpose2d_d2s(x, w, b=None, *, preferred_dtype=jnp.float32):
    """ConvTranspose2d(k=4, s=2, p=1) as ONE dense 3x3 conv + depth-to-space.

    Math-exact rewrite of ``conv_transpose2d(x, w, stride=2, padding=1)`` for
    the 4x4 kernel the generators use (reference enhanced_generator.py's
    up-ladder / pretrain.py decoder): XLA lowers a transposed conv via
    lhs_dilation (zero-stuffed input) whose implicit zeros can waste 3/4 of
    the products; here the four output phases come out of one ordinary 3x3 conv
    with 4*Cout dense output lanes, then a free reshape/transpose interleaves
    them. The kernel rewrite is a tiny constant-shaped scatter that XLA
    hoists out of the batch loop. Autodiff works through it (conv + d2s are
    both differentiable), so the fast training path can use it too.
    """
    b_, h, wdt, _ = x.shape
    cout = w.shape[3]
    k = _convt_k4s2p1_phase_kernel(w)
    out = conv2d(x, k, padding=1, preferred_dtype=preferred_dtype)
    out = out.reshape(b_, h, wdt, 2, 2, cout)
    out = out.transpose(0, 1, 3, 2, 4, 5).reshape(b_, 2 * h, 2 * wdt, cout)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out


def linear(x, w, b=None, *, preferred_dtype=jnp.float32):
    """Dense layer matching ``torch.nn.functional.linear`` (w is (out, in))."""
    out = jnp.dot(x, w.T.astype(x.dtype),
                  preferred_element_type=preferred_dtype).astype(x.dtype)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out
