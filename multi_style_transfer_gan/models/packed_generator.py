"""Packed (space-to-depth) EnhancedGenerator forward, the second engine.

Executes the exact EnhancedGenerator math (enhanced_generator.py:210-228 in
the reference; `enhanced_generator_apply` here) on s2d(4) tensors: every
activation's trailing dim is >= 48 (vs 16 in NHWC at channels=16), the 4x4
LocalAttention windows coincide with packed pixels (window partitioning
becomes free reshapes), and all convs become wide-channel convs via exact
weight repacking (ops/packed.py). Whether it beats the NHWC engine on the
GPU has not been measured; ``engine="packed"`` selects it.

Usage:
    packed = pack_enhanced_generator_params(params)        # once per load
    y = packed_enhanced_generator_apply(packed, x)          # jittable

`x` is (B, H, W, 3) in [-1, 1] with H, W divisible by 32 (the window-8
transformer grid constraint — 256/512/... all qualify; the generic
`enhanced_generator_apply` covers other sizes). Output matches the unpacked
forward to float rounding (~1e-5 fp32; verified in tests/test_packed.py).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..core import linear, relu, tanh
from ..core.activations import gelu
from ..ops.packed import (
    space_to_depth, depth_to_space,
    pack_conv2d_spec, pack_conv2d_weight, packed_conv2d,
    pack_conv_transpose2d_weight, pack_conv_transpose2d_spec,
    packed_conv_transpose2d,
    packed_instance_norm, packed_per_channel_linear,
    packed_window_channel_attention, packed_global_avg_pool,
)
from .enhanced_generator import _MSB_BRANCHES, num_transformer_blocks_of
from .structural_transformer import _layer_norm

F = 4  # packing factor == LocalAttention window size


# ---------------------------------------------------------------------------
# Parameter packing (run once per model load)
# ---------------------------------------------------------------------------

def _pack_params_impl(params):
    n_blocks = num_transformer_blocks_of(params)
    p = {}

    def conv(key, **kw):
        w_p, b_p, _ = pack_conv2d_weight(params[f"{key}.weight"],
                                         params[f"{key}.bias"],
                                         f_in=F, f_out=F, **kw)
        p[f"{key}.weight"], p[f"{key}.bias"] = w_p, b_p

    def convt(key, **kw):
        w_p, b_p, _ = pack_conv_transpose2d_weight(params[f"{key}.weight"],
                                                   params[f"{key}.bias"],
                                                   f_in=F, f_out=F, **kw)
        p[f"{key}.weight"], p[f"{key}.bias"] = w_p, b_p

    def matrix(key):
        w = params[f"{key}.weight"]
        p[f"{key}.weight"] = w.reshape(w.shape[-2], w.shape[-1])
        p[f"{key}.bias"] = params[f"{key}.bias"]

    conv("initial.0", stride=1, padding=3)
    for name in ("down1", "down2"):
        conv(f"{name}.0", stride=2, padding=1)
    for name in ("up1", "up2"):
        convt(f"{name}.0", stride=2, padding=1)
    conv("output.0", stride=1, padding=3)

    for name in ("down1", "down2", "up1", "up2"):
        matrix(f"{name}.3.qkv")
        matrix(f"{name}.3.proj")
        matrix(f"{name}.4.branch1.0")  # 1x1 -> per-channel linear
        matrix(f"{name}.4.fusion.0")
        for bname, k, pad, dil in _MSB_BRANCHES[1:]:
            conv(f"{name}.4.{bname}.0", stride=1, padding=pad, dilation=dil)

    for i in range(n_blocks):
        pre = f"transformer_blocks.{i}."
        conv(f"{pre}struct_embed.0", stride=2, padding=1)
        conv(f"{pre}struct_embed.2", stride=2, padding=1)
        for k in ("struct_proj", "style_mod", "attn.qkv", "attn.proj",
                  "mlp.fc1", "mlp.fc2", "norm1", "norm2"):
            for suf in ("weight", "bias"):
                p[f"{pre}{k}.{suf}"] = params[f"{pre}{k}.{suf}"]
    p["style_encoder.2.weight"] = params["style_encoder.2.weight"]
    p["style_encoder.2.bias"] = params["style_encoder.2.bias"]
    return p


def pack_enhanced_generator_params(params, dtype=None):
    """Repack an EnhancedGenerator param dict for the packed forward.

    One jitted call (all-einsum graph). Optionally casts weights to
    ``dtype`` (bf16 for the inference fast path)."""
    packed = jax.jit(_pack_params_impl)(params)
    if dtype is not None:
        packed = {k: v.astype(dtype) for k, v in packed.items()}
    return packed


# ---------------------------------------------------------------------------
# Packed layer helpers
# ---------------------------------------------------------------------------

def _attention(p, x, prefix):
    return packed_window_channel_attention(
        x, p[f"{prefix}qkv.weight"], p[f"{prefix}qkv.bias"],
        p[f"{prefix}proj.weight"], p[f"{prefix}proj.bias"], f=F)


def _msb(p, x, prefix, c):
    """MultiScaleBlock on packed tensors (enhanced_generator.py:49-84)."""
    outs = []
    for bname, k, pad, dil in _MSB_BRANCHES:
        key = f"{prefix}{bname}.0"
        if k == 1:
            h = packed_per_channel_linear(x, p[f"{key}.weight"],
                                          p[f"{key}.bias"], F)
        else:
            spec = pack_conv2d_spec(k, f_in=F, f_out=F, stride=1,
                                    padding=pad, dilation=dil)
            h = packed_conv2d(x, p[f"{key}.weight"], p[f"{key}.bias"], spec)
        outs.append(h)
    # interleave phases so concat matches the original channel order; IN is
    # per-channel so a single post-concat IN+ReLU equals per-branch passes
    B, Hp, Wp, _ = outs[0].shape
    P = F * F
    h = jnp.concatenate([o.reshape(B, Hp, Wp, P, c // 4) for o in outs],
                        axis=-1).reshape(B, Hp, Wp, P * c)
    h = relu(packed_instance_norm(h, F))
    h = packed_per_channel_linear(h, p[f"{prefix}fusion.0.weight"],
                                  p[f"{prefix}fusion.0.bias"], F)
    return relu(packed_instance_norm(h, F)) + x


def _ln_per_token(x, w, b):
    """LayerNorm over the original token dim on a packed (..., P*C) tensor."""
    shp = x.shape
    C = w.shape[0]
    t = x.reshape(*shp[:-1], F * F, C)
    return _layer_norm(t, w, b).reshape(shp)


def _packed_window8_mhsa(tokens_p, qkv_w, qkv_b, proj_w, proj_b, dim):
    """Window-8 MHSA on a packed token grid (B, Hp, Wp, P*dim).

    An 8x8 token window is a 2x2 block of packed pixels. Attention is
    permutation-equivariant over window positions, so any consistent
    position ordering inside the window yields identical outputs; we use the
    natural reshape order. Zero-padding of odd packed grids matches the
    reference's pad-to-8 exactly (both pad the same 4-token slabs).
    """
    B, Hp, Wp, Cp = tokens_p.shape
    P = F * F
    from .structural_transformer import default_num_heads
    heads = default_num_heads(dim)
    hd = dim // heads

    qkv = packed_per_channel_linear(tokens_p, qkv_w.T, qkv_b, F)
    pad_h, pad_w = Hp % 2, Wp % 2
    if pad_h or pad_w:
        qkv = jnp.pad(qkv, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    Hq, Wq = Hp + pad_h, Wp + pad_w
    t = qkv.reshape(B, Hq // 2, 2, Wq // 2, 2, P, 3 * dim)
    t = t.transpose(0, 1, 3, 2, 4, 5, 6).reshape(-1, 4 * P, 3 * dim)
    q, k, v = jnp.split(t, 3, axis=-1)

    def split_heads(u):
        Bw, T, _ = u.shape
        return u.reshape(Bw, T, heads, hd).transpose(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scale = 1.0 / jnp.sqrt(jnp.array(hd, jnp.float32))
    attn = jnp.einsum("bhtd,bhsd->bhts", q, k,
                      preferred_element_type=jnp.float32) * scale
    attn = jax.nn.softmax(attn, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhts,bhsd->bhtd", attn, v,
                     preferred_element_type=jnp.float32).astype(tokens_p.dtype)
    out = out.transpose(0, 2, 1, 3).reshape(-1, 4 * P, dim)
    out = out.reshape(B, Hq // 2, Wq // 2, 2, 2, P, dim)
    out = out.transpose(0, 1, 3, 2, 4, 5, 6).reshape(B, Hq, Wq, P * dim)
    if pad_h or pad_w:
        out = out[:, :Hp, :Wp, :]
    return packed_per_channel_linear(out, proj_w.T, proj_b, F)


def _packed_transformer_block(p, tokens_p, style, xp_input, prefix, dim):
    """StructuralTransformerBlock on packed tensors (see
    structural_transformer.py for the block design)."""
    g = lambda n: p[f"{prefix}{n}"]
    B, Hp, Wp, _ = tokens_p.shape

    spec = pack_conv2d_spec(3, f_in=F, f_out=F, stride=2, padding=1)
    s = relu(packed_conv2d(xp_input, g("struct_embed.0.weight"),
                           g("struct_embed.0.bias"), spec))
    s = relu(packed_conv2d(s, g("struct_embed.2.weight"),
                           g("struct_embed.2.bias"), spec))
    if s.shape[1:3] != (Hp, Wp):
        s = depth_to_space(s, F)
        s = jax.image.resize(s, (B, Hp * F, Wp * F, s.shape[-1]), "bilinear")
        s = space_to_depth(s, F)
    struct = packed_per_channel_linear(s, g("struct_proj.weight").T,
                                       g("struct_proj.bias"), F)

    mod = linear(style, g("style_mod.weight"), g("style_mod.bias"))
    gamma, beta = jnp.split(mod, 2, axis=-1)

    gamma = jnp.tile(gamma, (1, F * F))[:, None, None, :]
    beta = jnp.tile(beta, (1, F * F))[:, None, None, :]

    h = _ln_per_token(tokens_p + struct, g("norm1.weight"), g("norm1.bias"))
    h = h * (1.0 + gamma) + beta
    tokens_p = tokens_p + _packed_window8_mhsa(
        h, g("attn.qkv.weight"), g("attn.qkv.bias"),
        g("attn.proj.weight"), g("attn.proj.bias"), dim)

    h = _ln_per_token(tokens_p, g("norm2.weight"), g("norm2.bias"))
    h = packed_per_channel_linear(h, g("mlp.fc1.weight").T,
                                  g("mlp.fc1.bias"), F)
    h = gelu(h)
    h = packed_per_channel_linear(h, g("mlp.fc2.weight").T,
                                  g("mlp.fc2.bias"), F)
    return tokens_p + h


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def packed_enhanced_generator_apply(packed, x):
    """EnhancedGenerator forward on s2d(4) tensors.

    x: (B, H, W, 3) in [-1, 1], H and W divisible by 32. Returns (B, H, W, 3).
    """
    p = packed
    # structure is static from (packed) weight shapes, like channels_of()
    c = p["initial.0.weight"].shape[-1] // (F * F)
    n_blocks = num_transformer_blocks_of(p)

    xp = space_to_depth(x, F)

    spec7 = pack_conv2d_spec(7, f_in=F, f_out=F, stride=1, padding=3)
    spec4s2 = pack_conv2d_spec(4, f_in=F, f_out=F, stride=2, padding=1)
    spect = pack_conv_transpose2d_spec(4, f_in=F, f_out=F, stride=2,
                                       padding=1)

    h = relu(packed_instance_norm(
        packed_conv2d(xp, p["initial.0.weight"], p["initial.0.bias"], spec7),
        F))

    widths = {"down1": 2 * c, "down2": 4 * c}
    for name in ("down1", "down2"):
        h = packed_conv2d(h, p[f"{name}.0.weight"], p[f"{name}.0.bias"],
                          spec4s2)
        h = relu(packed_instance_norm(h, F))
        h = _attention(p, h, f"{name}.3.")
        h = _msb(p, h, f"{name}.4.", widths[name])

    style = packed_global_avg_pool(h, F)
    style = relu(linear(style, p["style_encoder.2.weight"],
                        p["style_encoder.2.bias"]))

    for i in range(n_blocks):
        h = _packed_transformer_block(p, h, style, xp,
                                      f"transformer_blocks.{i}.", 4 * c)

    for name, w in (("up1", 2 * c), ("up2", c)):
        Hp, Wp = h.shape[1] * 2, h.shape[2] * 2
        h = packed_conv_transpose2d(h, p[f"{name}.0.weight"],
                                    p[f"{name}.0.bias"], spect,
                                    out_hw=(Hp, Wp))
        h = relu(packed_instance_norm(h, F))
        h = _attention(p, h, f"{name}.3.")
        h = _msb(p, h, f"{name}.4.", w)

    h = packed_conv2d(h, p["output.0.weight"], p["output.0.bias"], spec7)
    return depth_to_space(tanh(h), F)
