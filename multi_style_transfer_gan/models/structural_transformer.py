"""StructuralTransformerBlock — style- and structure-conditioned transformer.

The reference imports ``structural_transformer.StructuralTransformerBlock``
(enhanced_generator.py:4) but that module is NOT present in the reference
repository; only its call signature survives:

    block = StructuralTransformerBlock(dim=channels*4)      # :114-117
    x = block(x_tokens, style_vec, orig_input_image)        # :222-223

where ``x_tokens`` is (B, H*W, dim) flattened bottleneck features, ``style_vec``
is (B, dim) from the GAP+Linear style encoder, and ``orig_input_image`` is the
raw (B, 3, H0, W0) network input (H0 = 4*H). This file *designs* the block
(SURVEY.md §7 "hard parts"):

- **Windowed multi-head self-attention** over the token grid (window 8x8 = 64
  tokens). Global attention over H*W tokens is O(N^2) at 512^2 inputs
  (N=16384); windowing keeps every attention matrix a small (64 x 64) tile
  and makes cost linear in N, so the same block serves 256^2 training and
  large-image inference.
- **Style conditioning via FiLM**: the style vector produces per-channel
  (gamma, beta) applied after the pre-attention LayerNorm — one fused
  elementwise op, no extra attention cost.
- **Structure conditioning**: the original image is embedded by two stride-2
  convs (receptive field matched to the 4x downsampled token grid), resized to
  the token grid, projected, and added to the tokens before attention. This
  gives every token a direct shortcut to the input's local structure — the
  "structural" part — independent of the style path.
- Pre-norm residual MLP (ratio 4, GELU) completes a standard pre-LN block.

Parameter keys (our schema; documented for checkpoint compatibility):
  struct_embed.{0,2}.{weight,bias}   two 3x3 stride-2 convs: 3 -> dim//2 -> dim
  struct_proj.{weight,bias}          Linear(dim, dim)
  style_mod.{weight,bias}            Linear(dim, 2*dim) -> (gamma, beta)
  norm1.{weight,bias} norm2.{weight,bias}   LayerNorms
  attn.qkv.{weight,bias} attn.proj.{weight,bias}
  mlp.fc1.{weight,bias} mlp.fc2.{weight,bias}
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import conv2d, linear, relu
from ..core.activations import gelu
from .init_utils import kaiming_conv, torch_default_linear


def structural_transformer_init(key, dim: int, dtype=jnp.float32):
    keys = jax.random.split(key, 8)
    p = {}
    w, b = kaiming_conv(keys[0], (3, 3, 3, dim // 2), dtype=dtype)
    p["struct_embed.0.weight"], p["struct_embed.0.bias"] = w, b
    w, b = kaiming_conv(keys[1], (3, 3, dim // 2, dim), dtype=dtype)
    p["struct_embed.2.weight"], p["struct_embed.2.bias"] = w, b
    for name, (o, i), k in [
        ("struct_proj", (dim, dim), keys[2]),
        ("style_mod", (2 * dim, dim), keys[3]),
        ("attn.qkv", (3 * dim, dim), keys[4]),
        ("attn.proj", (dim, dim), keys[5]),
        ("mlp.fc1", (4 * dim, dim), keys[6]),
        ("mlp.fc2", (dim, 4 * dim), keys[7]),
    ]:
        w, b = torch_default_linear(k, o, i, dtype)
        p[f"{name}.weight"], p[f"{name}.bias"] = w, b
    # style_mod starts at identity modulation (gamma=0 offset handled in apply).
    p["style_mod.weight"] = jnp.zeros_like(p["style_mod.weight"])
    p["style_mod.bias"] = jnp.zeros_like(p["style_mod.bias"])
    for n in ("norm1", "norm2"):
        p[f"{n}.weight"] = jnp.ones((dim,), dtype)
        p[f"{n}.bias"] = jnp.zeros((dim,), dtype)
    return p


def default_num_heads(dim: int) -> int:
    """Largest head count <= dim//32 that DIVIDES dim (1 if none): the
    naive max(1, dim//32) crashes split_heads for widths like 112 where
    dim//32 doesn't divide dim (channel width is checkpoint-auto-detected,
    so arbitrary widths reach here). Matches the old formula at every
    standard width (dim = 4*channels for channels 16/32/64)."""
    h = max(1, dim // 32)
    while dim % h:
        h -= 1
    return h


def _layer_norm(x, w, b, eps=1e-5):
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    out = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (out * w + b).astype(x.dtype)


def _window_attention(tokens, grid_hw, qkv_w, qkv_b, proj_w, proj_b,
                      *, window: int = 8, num_heads: int | None = None):
    """Windowed MHSA over a (B, H*W, C) token grid.

    Pads the grid to window multiples (zero pad; padded tokens attend within
    their window only and are cropped after), partitions into (window, window)
    tiles, and runs dense attention per tile — every matmul is a small static
    tile, no dynamic shapes.
    """
    B, N, C = tokens.shape
    H, W = grid_hw
    heads = num_heads or default_num_heads(C)
    hd = C // heads

    qkv = linear(tokens, qkv_w, qkv_b)  # (B, N, 3C)
    x = qkv.reshape(B, H, W, 3 * C)
    pad_h = (-H) % window
    pad_w = (-W) % window
    if pad_h or pad_w:
        x = jnp.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    Hp, Wp = H + pad_h, W + pad_w
    nh, nw = Hp // window, Wp // window
    # (B, nh, win, nw, win, 3C) -> (B*nh*nw, win*win, 3C)
    x = x.reshape(B, nh, window, nw, window, 3 * C)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window, 3 * C)
    q, k, v = jnp.split(x, 3, axis=-1)

    def split_heads(t):  # (Bw, T, C) -> (Bw, heads, T, hd)
        Bw, T, _ = t.shape
        return t.reshape(Bw, T, heads, hd).transpose(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scale = 1.0 / jnp.sqrt(jnp.array(hd, jnp.float32))
    attn = jnp.einsum("bhtd,bhsd->bhts", q, k,
                      preferred_element_type=jnp.float32) * scale
    if pad_h or pad_w:
        # mask padded KEYS or their exp(0)=1 terms dilute every real
        # query's softmax in boundary windows (zero-pad qkv is not enough)
        valid = jnp.pad(jnp.ones((H, W), jnp.float32),
                        ((0, pad_h), (0, pad_w)))
        valid = valid.reshape(nh, window, nw, window)
        valid = valid.transpose(0, 2, 1, 3).reshape(nh * nw,
                                                    window * window)
        key_mask = jnp.tile(valid, (B, 1))[:, None, None, :]  # (Bw,1,1,S)
        attn = jnp.where(key_mask > 0, attn, -jnp.inf)
    attn = jax.nn.softmax(attn, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhts,bhsd->bhtd", attn, v,
                     preferred_element_type=jnp.float32).astype(tokens.dtype)
    out = out.transpose(0, 2, 1, 3).reshape(-1, window * window, C)
    # un-window
    out = out.reshape(B, nh, nw, window, window, C)
    out = out.transpose(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if pad_h or pad_w:
        out = out[:, :H, :W, :]
    out = out.reshape(B, N, C)
    return linear(out, proj_w, proj_b)


def _block_body_math(tokens, struct_tokens, gamma, beta,
                     n1w, n1b, qkvw, qkvb, projw, projb,
                     n2w, n2b, f1w, f1b, f2w, f2b, *, grid_hw, window):
    """The XLA block body (autodiff-capable): LN1+FiLM -> window MHSA ->
    LN2 -> MLP with both residuals, on (B, H*W, C) tokens."""
    h = _layer_norm(tokens + struct_tokens, n1w, n1b)
    h = h * (1.0 + gamma[:, None, :]) + beta[:, None, :]
    tokens = tokens + _window_attention(h, grid_hw, qkvw, qkvb, projw, projb,
                                        window=window)
    h = _layer_norm(tokens, n2w, n2b)
    h = linear(h, f1w, f1b)
    h = gelu(h)
    h = linear(h, f2w, f2b)
    return tokens + h


def structural_transformer_apply(params, tokens, style, orig_image, grid_hw,
                                 *, prefix: str = "", window: int = 8):
    """Apply one block.

    Args:
      params: flat dict (optionally with ``prefix`` like "transformer_blocks.0.").
      tokens: (B, H*W, dim) bottleneck tokens.
      style: (B, dim) style vector.
      orig_image: (B, H0, W0, 3) network input in [-1, 1] (NHWC).
      grid_hw: static (H, W) of the token grid.
    """
    g = lambda name: params[f"{prefix}{name}"]
    B, N, C = tokens.shape
    H, W = grid_hw

    # Structure path: embed original image, align to the token grid.
    s = conv2d(orig_image, g("struct_embed.0.weight"), g("struct_embed.0.bias"),
               stride=2, padding=1)
    s = relu(s)
    s = conv2d(s, g("struct_embed.2.weight"), g("struct_embed.2.bias"),
               stride=2, padding=1)
    s = relu(s)
    if s.shape[1:3] != (H, W):
        s = jax.image.resize(s, (B, H, W, s.shape[-1]), method="bilinear")
    struct_tokens = linear(s.reshape(B, N, C), g("struct_proj.weight"),
                           g("struct_proj.bias"))

    # Style FiLM on the pre-attention norm (identity at init).
    mod = linear(style, g("style_mod.weight"), g("style_mod.bias"))  # (B, 2C)
    gamma, beta = jnp.split(mod, 2, axis=-1)

    weights = (g("norm1.weight"), g("norm1.bias"),
               g("attn.qkv.weight"), g("attn.qkv.bias"),
               g("attn.proj.weight"), g("attn.proj.bias"),
               g("norm2.weight"), g("norm2.bias"),
               g("mlp.fc1.weight"), g("mlp.fc1.bias"),
               g("mlp.fc2.weight"), g("mlp.fc2.bias"))

    return _block_body_math(tokens, struct_tokens, gamma, beta, *weights,
                            grid_hw=grid_hw, window=window)
