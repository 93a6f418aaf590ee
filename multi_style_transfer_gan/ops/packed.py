"""Space-to-depth packed execution — wide-channel layouts for small-C models.

Why this exists (no reference equivalent): the deployed EnhancedGenerator
runs at channels=16 (enhanced_train.py:18), so its NHWC activations have
trailing dims of 16/32/64. A layout whose trailing dim is padded to a wide
tile moves several times the useful bytes for such tensors.

The packed engine executes the network on space-to-depth (s2d) tensors. An f x f block
of pixels folds into the channel dim — (B, H, W, C) -> (B, H/f, W/f, f*f*C),
channel order (phase_i, phase_j, c) — and every layer is re-expressed to
operate natively on the packed layout with EXACTLY the same math:

- conv / conv-transpose: weights are repacked once per model load by an
  exact linear index mapping (`pack_conv2d_weight` / `pack_conv_transpose2d_weight`);
  the packed op is a single dense `lax.conv` on f*f-times-wider channels
  (Cin/Cout >= 128 instead of 16).
- InstanceNorm: per-original-channel statistics become group statistics over
  the f*f phase channels (`packed_instance_norm`).
- windowed channel attention (LocalAttention, ws=4): with f == ws == 4 an
  attention window IS one packed pixel, so window partitioning — the
  transpose-heavy part of the unpacked path — becomes a free minor-dim
  reshape (`packed channel order == window-position order`).

With f chosen per grid so that trailing dims are >= 128, the packed forward
is numerically identical to `enhanced_generator_apply` (same ops, same
accumulation dtypes; only conv tap summation order differs) — verified to
~1e-5 in tests/test_packed.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_DIMNUMS = ("NHWC", "HWIO", "NHWC")


# ---------------------------------------------------------------------------
# Layout transforms
# ---------------------------------------------------------------------------

def space_to_depth(x, f: int):
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C), channel order (pi, pj, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // f, f, W // f, f, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // f, W // f, f * f * C)


def depth_to_space(x, f: int):
    """Inverse of :func:`space_to_depth`."""
    B, Hp, Wp, Cp = x.shape
    C = Cp // (f * f)
    x = x.reshape(B, Hp, Wp, f, f, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp * f, Wp * f, C)


# ---------------------------------------------------------------------------
# Exact conv weight repacking
# ---------------------------------------------------------------------------

def _conv_axis_map(K: int, stride: int, pad: int, dil: int,
                   f_in: int, f_out: int):
    """1-D tap mapping for a conv between s2d grids.

    Original: y[t] = sum_k w[k] x[stride*t + dil*k - pad].
    Packed output index u, phase a (t = f_out*u + a); packed input v, phase b
    (m = f_in*v + b). For each (a, k): q = stride*a + dil*k - pad gives
    d = q // f_in (packed tap offset) and b = q % f_in.

    Returns (M, d_min, K_p, stride_p) where M is a 0/1 numpy tensor of shape
    (K, f_out, K_p, f_in) with M[k, a, d - d_min, b] = 1.
    """
    assert (stride * f_out) % f_in == 0, "incompatible packing factors"
    stride_p = (stride * f_out) // f_in
    entries = []
    for a in range(f_out):
        for k in range(K):
            q = stride * a + dil * k - pad
            entries.append((k, a, q // f_in, q % f_in))
    d_min = min(e[2] for e in entries)
    d_max = max(e[2] for e in entries)
    K_p = d_max - d_min + 1
    M = np.zeros((K, f_out, K_p, f_in), np.float32)
    for k, a, d, b in entries:
        M[k, a, d - d_min, b] = 1.0
    return M, d_min, K_p, stride_p


def pack_conv2d_spec(K, *, f_in: int, f_out: int, stride=1, padding=0,
                     dilation=1):
    """The static {stride, padding} spec of a repacked conv — host-side
    integer math only (no array work); matches pack_conv2d_weight."""
    Kh, Kw = (K, K) if isinstance(K, int) else tuple(K)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    d = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    _, dmin_i, _, sp_h = _conv_axis_map(Kh, s[0], p[0], d[0], f_in, f_out)
    _, dmin_j, _, sp_w = _conv_axis_map(Kw, s[1], p[1], d[1], f_in, f_out)
    return {"stride": (sp_h, sp_w),
            "padding": ((-dmin_i, -dmin_i), (-dmin_j, -dmin_j))}


def pack_conv2d_weight(w, b, *, f_in: int, f_out: int, stride=1, padding=0,
                       dilation=1):
    """Repack an HWIO conv kernel to act on s2d(f_in) input -> s2d(f_out) out.

    Returns (w_p, b_p, spec) where spec = dict(stride, padding) for
    :func:`packed_conv2d`. The mapping is exact: the packed conv computes the
    same sums as the original conv on the unpacked tensors (zero padding in
    the packed domain corresponds to whole-pixel zero padding in the original
    domain, and taps that would reach non-padded original pixels carry zero
    weight by construction).
    """
    Kh, Kw, Cin, Cout = w.shape
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    d = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    Mi, dmin_i, Kph, sp_h = _conv_axis_map(Kh, s[0], p[0], d[0], f_in, f_out)
    Mj, dmin_j, Kpw, sp_w = _conv_axis_map(Kw, s[1], p[1], d[1], f_in, f_out)
    # w_p[d, e, (b, g, i), (a, c, o)] = sum_{k,l} Mi[k,a,d,b] Mj[l,c,e,g] w[k,l,i,o]
    w_p = jnp.einsum("kadb,lceg,klio->debgiaco", Mi, Mj,
                     w.astype(jnp.float32))
    w_p = w_p.reshape(Kph, Kpw, f_in * f_in * Cin, f_out * f_out * Cout)
    w_p = w_p.astype(w.dtype)
    b_p = None if b is None else jnp.tile(b, f_out * f_out)
    return w_p, b_p, {"stride": (sp_h, sp_w),
                      "padding": ((-dmin_i, -dmin_i), (-dmin_j, -dmin_j))}


def packed_conv2d(x, w_p, b_p, spec, *, preferred_dtype=jnp.float32,
                  out_hw=None):
    """Conv on packed tensors using a repacked kernel (supports the negative
    effective padding that repacking can produce).

    out_hw: expected packed output (H, W). The spec's symmetric ``-d_min``
    padding is exact for ``f_in == f_out`` but over-produces trailing rows
    when ``f_in != f_out`` (the right edge needs less reach than the left);
    pass the true packed output dims to crop — matching
    :func:`packed_conv_transpose2d`'s ``out_hw``.
    """
    ph, pw = spec["padding"]
    out = lax.conv_general_dilated(
        x, w_p.astype(x.dtype), window_strides=spec["stride"],
        padding=[ph, pw], dimension_numbers=_DIMNUMS,
        preferred_element_type=preferred_dtype).astype(x.dtype)
    if b_p is not None:
        out = out + b_p.astype(out.dtype)
    if out_hw is not None:
        out = out[:, :out_hw[0], :out_hw[1], :]
    return out


def _convt_axis_map(K: int, stride: int, pad: int, f_in: int, f_out: int):
    """1-D tap mapping for ConvTranspose between s2d grids.

    Original (torch semantics): y[t] += w[k] x[m] whenever t = stride*m + k - pad.
    Packed: t = f_out*u + a, m = f_in*v + b. Contribution exists when
    k = f_out*e + a + pad - stride*b for e = u - S_pp*v in a small range,
    with packed stride S_pp = stride*f_in/f_out.

    Returns (M, e_min, K_p, S_pp) with M[k, a, e - e_min, b] = 1.
    """
    assert (stride * f_in) % f_out == 0, "incompatible packing factors"
    S_pp = (stride * f_in) // f_out
    entries = []
    for a in range(f_out):
        for b in range(f_in):
            for k in range(K):
                num = k - a - pad + stride * b
                if num % f_out:
                    continue
                entries.append((k, a, num // f_out, b))
    e_min = min(e[2] for e in entries)
    e_max = max(e[2] for e in entries)
    K_p = e_max - e_min + 1
    M = np.zeros((K, f_out, K_p, f_in), np.float32)
    for k, a, e, b in entries:
        M[k, a, e - e_min, b] = 1.0
    return M, e_min, K_p, S_pp


def pack_conv_transpose2d_spec(K, *, f_in: int, f_out: int, stride=1,
                               padding=0):
    """The static {stride, padding, kernel} spec of a repacked transposed
    conv — host-side integer math only; matches
    pack_conv_transpose2d_weight."""
    Kh, Kw = (K, K) if isinstance(K, int) else tuple(K)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    _, emin_i, Kph, sp_h = _convt_axis_map(Kh, s[0], p[0], f_in, f_out)
    _, emin_j, Kpw, sp_w = _convt_axis_map(Kw, s[1], p[1], f_in, f_out)
    return {"stride": (sp_h, sp_w), "padding": ((-emin_i), (-emin_j)),
            "kernel": (Kph, Kpw)}


def pack_conv_transpose2d_weight(w, b, *, f_in: int, f_out: int, stride=1,
                                 padding=0):
    """Repack an HWIO transposed-conv kernel for packed execution.

    The packed op is again a torch-semantics ConvTranspose2d (executed via
    :func:`multi_style_transfer_gan.core.conv_transpose2d`) with kernel
    K_p, stride stride*f_in/f_out and padding -e_min; output_padding is chosen
    so packed output sizes match exactly.
    """
    Kh, Kw, Cin, Cout = w.shape
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    Mi, emin_i, Kph, sp_h = _convt_axis_map(Kh, s[0], p[0], f_in, f_out)
    Mj, emin_j, Kpw, sp_w = _convt_axis_map(Kw, s[1], p[1], f_in, f_out)
    w_p = jnp.einsum("kadb,lceg,klio->debgiaco", Mi, Mj,
                     w.astype(jnp.float32))
    w_p = w_p.reshape(Kph, Kpw, f_in * f_in * Cin, f_out * f_out * Cout)
    w_p = w_p.astype(w.dtype)
    b_p = None if b is None else jnp.tile(b, f_out * f_out)
    return w_p, b_p, {"stride": (sp_h, sp_w),
                      "padding": ((-emin_i), (-emin_j)),
                      "kernel": (Kph, Kpw)}


def packed_conv_transpose2d(x, w_p, b_p, spec, *, out_hw,
                            preferred_dtype=jnp.float32):
    """Packed ConvTranspose with exact output size via output_padding."""
    sh, sw = spec["stride"]
    ph, pw = spec["padding"]
    Kph, Kpw = spec["kernel"]
    H, W = x.shape[1], x.shape[2]
    op_h = out_hw[0] - ((H - 1) * sh - 2 * ph + Kph)
    op_w = out_hw[1] - ((W - 1) * sw - 2 * pw + Kpw)
    assert 0 <= op_h < max(sh, 1) + 1 and 0 <= op_w < max(sw, 1) + 1, \
        (op_h, op_w)
    from ..core import conv_transpose2d

    return conv_transpose2d(x, w_p, b_p, stride=(sh, sw), padding=(ph, pw),
                            output_padding=(op_h, op_w),
                            preferred_dtype=preferred_dtype)


# ---------------------------------------------------------------------------
# Packed layer math
# ---------------------------------------------------------------------------

def packed_instance_norm(x, f: int, *, eps: float = 1e-5):
    """InstanceNorm over (H, W, phases) per original channel.

    x: (B, Hp, Wp, f*f*C) packed; statistics pool the f*f phase copies of
    each original channel — identical to unpacked per-channel stats.
    """
    B, Hp, Wp, Cp = x.shape
    C = Cp // (f * f)
    xf = x.astype(jnp.float32).reshape(B, Hp, Wp, f * f, C)
    mean = jnp.mean(xf, axis=(1, 2, 3), keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=(1, 2, 3), keepdims=True)
    out = (xf - mean) * lax.rsqrt(var + eps)
    return out.reshape(B, Hp, Wp, Cp).astype(x.dtype)


def packed_per_channel_linear(x, w, b, f: int, *,
                              preferred_dtype=jnp.float32):
    """Apply an original-channel (C_in -> C_out) matmul per phase.

    x: (..., f*f*C_in) -> (..., f*f*C_out); w: (C_in, C_out). Equivalent to a
    1x1 conv on the unpacked tensor. Runs as a batched matmul over the phase
    sub-axis — a pure minor-dim reshape, no spatial relayout.
    """
    Cin, Cout = w.shape
    shp = x.shape
    t = x.reshape(*shp[:-1], f * f, Cin)
    out = jnp.einsum("...pc,cd->...pd", t, w.astype(x.dtype),
                     preferred_element_type=preferred_dtype).astype(x.dtype)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out.reshape(*shp[:-1], f * f * Cout)


def packed_window_channel_attention(x, wqkv, bqkv, wproj, bproj, *, f: int,
                                    eps: float = 1e-12):
    """LocalAttention (windowed channel attention, ws == f) on packed input.

    With f == window_size, each packed pixel holds exactly one window in
    window-position order, so the reference's pad/partition/unpartition
    (enhanced_generator.py:13-47) reduces to minor-dim reshapes. Numerics
    match `local_attention_apply` (same zero-safe L2 normalize, fp32
    softmax/accumulation).

    x: (B, Hp, Wp, f*f*C); wqkv: (C, 3C); wproj: (C, C).
    """
    B, Hp, Wp, Cp = x.shape
    P = f * f
    C = Cp // P
    t = x.reshape(B * Hp * Wp, P, C)
    qkv = jnp.einsum("bpc,cd->bpd", t, wqkv.astype(x.dtype),
                     preferred_element_type=jnp.float32).astype(x.dtype)
    qkv = qkv + bqkv.astype(qkv.dtype)
    q, k, v = jnp.split(qkv, 3, axis=-1)

    from ..core.norm import l2_normalize as _norm_impl
    _norm = lambda u: _norm_impl(u, eps)

    qn, kn = _norm(q), _norm(k)
    attn = jnp.einsum("btc,btd->bcd", qn, kn,
                      preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn, axis=-1)
    out = jnp.einsum("bcd,btd->btc", attn.astype(v.dtype), v,
                     preferred_element_type=jnp.float32).astype(x.dtype)
    out = jnp.einsum("bpc,cd->bpd", out, wproj.astype(x.dtype),
                     preferred_element_type=jnp.float32).astype(x.dtype)
    out = out + bproj.astype(out.dtype)
    return out.reshape(B, Hp, Wp, Cp)


def packed_global_avg_pool(x, f: int):
    """GAP over (H, W, phases) per original channel: (B,Hp,Wp,ffC) -> (B,C)."""
    B, Hp, Wp, Cp = x.shape
    C = Cp // (f * f)
    return jnp.mean(x.reshape(B, Hp, Wp, f * f, C), axis=(1, 2, 3))
