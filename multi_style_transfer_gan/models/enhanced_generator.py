"""EnhancedGenerator — the attention/transformer style-transfer generator.

Capability parity with the reference's ``EnhancedGenerator`` /
``LocalAttention`` / ``MultiScaleBlock`` (enhanced_generator.py:6-228):

- NHWC layout throughout; every norm/activation fuses into its producer
  under XLA.
- ``LocalAttention`` is *windowed channel attention* (cross-covariance over a
  C x C matrix per 4x4 window — enhanced_generator.py:13-47). In the XLA
  formulation (``_attention_math``, the reference) the 1x1 qkv and proj
  convs commute with window partitioning, so they are hoisted out of the
  window loop: one big (H*W, C)x(C, 3C) matmul, then a batched
  (C, ws^2)x(ws^2, C) einsum per window. Numerics are identical to the
  reference ordering. Inference on the GPU runs the fused kernel of
  ops/pallas/window_attention.py instead, which reads x once and writes
  the output once.
- The stride-2 4x4 conv / conv-transpose ladder matches PyTorch output sizes
  exactly so imported checkpoints reproduce (SSIM>=0.99 target).

Deployed reference config: channels=16, num_transformer_blocks=1
(enhanced_train.py:18-19); channel width is auto-detected from
``initial.0.weight`` at load time (direct_transform.py:25-30).

Parameter keys mirror the PyTorch ``state_dict()``:
  initial.0.*            7x7 stem conv
  down{1,2}.0.*          stride-2 conv
  down{1,2}.3.{qkv,proj}.*   LocalAttention
  down{1,2}.4.{branch1..4,fusion}.0.*  MultiScaleBlock convs
  transformer_blocks.{i}.*   StructuralTransformerBlock (our schema)
  up{1,2}.0.*            stride-2 transposed conv
  up{1,2}.{3,4}.*        attention / multiscale as above
  output.0.*             7x7 output conv
  style_encoder.2.*      Linear(4C, 4C)
(InstanceNorms are PyTorch-default affine=False: no parameters.)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import conv2d, conv_transpose2d, linear, relu, tanh
from ..core.norm import in_relu, instance_norm
from ..sharding_spec import ShardedFastAttention
from .init_utils import kaiming_conv, torch_default_linear
from .structural_transformer import (
    structural_transformer_apply, structural_transformer_init,
)


# ---------------------------------------------------------------------------
# LocalAttention (windowed channel attention)
# ---------------------------------------------------------------------------

def local_attention_apply(params, x, *, prefix: str, window_size: int = 4,
                          eps: float = 1e-12, fast=False):
    """Windowed channel attention; numerics match the reference module.

    x: (B, H, W, C) with H, W divisible by window_size (true for all
    reference resolutions: 256/128/64 with ws=4; the reference's pad branch
    is dead code incompatible with its own reshape — see SURVEY.md §2.1 —
    so we require divisibility rather than replicate the latent bug).

    fast: False = the XLA formulation (autodiff-capable, the reference);
    True = on the GPU, the fused Pallas-Triton kernel
    (ops/pallas/window_attention.py, inference only) where it takes the
    width, and the XLA formulation on any other platform; a
    ``ShardedFastAttention`` = the same, per batch or height shard.
    """
    g = lambda n: params[f"{prefix}{n}"]
    ws = window_size
    args = (x, g("qkv.weight"), g("qkv.bias"), g("proj.weight"),
            g("proj.bias"))
    reference = partial(_attention_math, window_size=ws, eps=eps)

    from ..ops.pallas.window_attention import (
        supports, window_channel_attention,
    )

    if not (fast and supports(x.shape[-1], ws)):
        return reference(*args)
    kernel = partial(window_channel_attention, window_size=ws, eps=eps)
    if isinstance(fast, ShardedFastAttention):
        # Windows never cross the batch or height shards, so each device
        # runs the kernel on its own shard.
        from jax.sharding import PartitionSpec as P

        kernel = jax.shard_map(
            kernel, mesh=fast.mesh,
            in_specs=(fast.spec, P(), P(), P(), P()),
            out_specs=fast.spec,
            check_vma=False,  # pallas_call declares no per-axis vma
        )
    return jax.lax.platform_dependent(*args, cuda=kernel, default=reference)


def _attention_math(x, wqkv, bqkv, wproj, bproj, *, window_size, eps):
    """The XLA einsum formulation (reference numerics, autodiff-capable)."""
    qkv = conv2d(x, wqkv, bqkv)  # (B, H, W, 3C)
    out = _attention_windows(qkv, window_size=window_size, eps=eps)
    return conv2d(out, wproj, bproj)


def _attention_windows(qkv, *, window_size, eps):
    """Window partition -> channel attention -> merge, from a precomputed
    qkv map. Split from _attention_math so callers that build qkv
    differently can reuse it."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    ws = window_size
    nh, nw = H // ws, W // ws
    t = qkv.reshape(B, nh, ws, nw, ws, 3 * C)
    t = t.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, 3 * C)
    q, k, v = jnp.split(t, 3, axis=-1)  # (Bw, ws^2, C)

    # F.normalize(dim=channel): unit L2 over channels at every position
    # (zero-safe shared helper, core.norm.l2_normalize)
    from ..core.norm import l2_normalize as _norm_impl
    _norm = lambda u: _norm_impl(u, eps)

    qn, kn = _norm(q), _norm(k)
    # attn[c1, c2] = sum_t qn[t, c1] * kn[t, c2]   -> (Bw, C, C)
    attn = jnp.einsum("btc,btd->bcd", qn, kn,
                      preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn, axis=-1)
    # out[t, c1] = sum_c2 attn[c1, c2] * v[t, c2]
    out = jnp.einsum("bcd,btd->btc", attn.astype(v.dtype), v,
                     preferred_element_type=jnp.float32).astype(qkv.dtype)

    out = out.reshape(B, nh, nw, ws, ws, C)
    out = out.transpose(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    return out


def local_attention_init(key, channels, dtype=jnp.float32):
    k1, k2 = jax.random.split(key)
    p = {}
    w, b = kaiming_conv(k1, (1, 1, channels, 3 * channels), dtype=dtype)
    p["qkv.weight"], p["qkv.bias"] = w, b
    w, b = kaiming_conv(k2, (1, 1, channels, channels), dtype=dtype)
    p["proj.weight"], p["proj.bias"] = w, b
    return p


# ---------------------------------------------------------------------------
# MultiScaleBlock (dilated pyramid + residual)
# ---------------------------------------------------------------------------

_MSB_BRANCHES = (  # (name, kernel, padding, dilation)
    ("branch1", 1, 0, 1),
    ("branch2", 3, 1, 1),
    ("branch3", 3, 2, 2),
    ("branch4", 3, 4, 4),
)


def multi_scale_block_apply(params, x, *, prefix: str):
    g = lambda n: params[f"{prefix}{n}"]
    outs = []
    for name, k, p, d in _MSB_BRANCHES:
        outs.append(conv2d(x, g(f"{name}.0.weight"), g(f"{name}.0.bias"),
                           padding=p, dilation=d))
    # InstanceNorm is per-channel, so IN+ReLU commutes with channel concat:
    # one pass over the concatenated tensor instead of four per-branch passes
    # (exact same numbers, fewer HBM round trips). in_relu = one-pass stats
    # + hand-written VJP (core.norm).
    h = in_relu(jnp.concatenate(outs, axis=-1))
    h = conv2d(h, g("fusion.0.weight"), g("fusion.0.bias"))
    return in_relu(h) + x


def multi_scale_block_init(key, channels, dtype=jnp.float32):
    keys = jax.random.split(key, 5)
    p = {}
    for (name, k, _, _), kk in zip(_MSB_BRANCHES, keys):
        w, b = kaiming_conv(kk, (k, k, channels, channels // 4), dtype=dtype)
        p[f"{name}.0.weight"], p[f"{name}.0.bias"] = w, b
    w, b = kaiming_conv(keys[4], (1, 1, channels, channels), dtype=dtype)
    p["fusion.0.weight"], p["fusion.0.bias"] = w, b
    return p


# ---------------------------------------------------------------------------
# EnhancedGenerator
# ---------------------------------------------------------------------------

def enhanced_generator_init(key, channels: int = 16,
                            num_transformer_blocks: int = 1,
                            dtype=jnp.float32):
    c = channels
    keys = iter(jax.random.split(key, 16 + num_transformer_blocks))
    p = {}

    w, b = kaiming_conv(next(keys), (7, 7, 3, c), dtype=dtype)
    p["initial.0.weight"], p["initial.0.bias"] = w, b

    for name, cin, cout in (("down1", c, 2 * c), ("down2", 2 * c, 4 * c)):
        w, b = kaiming_conv(next(keys), (4, 4, cin, cout), dtype=dtype)
        p[f"{name}.0.weight"], p[f"{name}.0.bias"] = w, b
        for k2, v in local_attention_init(next(keys), cout, dtype).items():
            p[f"{name}.3.{k2}"] = v
        for k2, v in multi_scale_block_init(next(keys), cout, dtype).items():
            p[f"{name}.4.{k2}"] = v

    for i in range(num_transformer_blocks):
        for k2, v in structural_transformer_init(next(keys), 4 * c, dtype).items():
            p[f"transformer_blocks.{i}.{k2}"] = v

    for name, cin, cout in (("up1", 4 * c, 2 * c), ("up2", 2 * c, c)):
        w, b = kaiming_conv(next(keys), (4, 4, cin, cout), dtype=dtype)
        p[f"{name}.0.weight"], p[f"{name}.0.bias"] = w, b
        for k2, v in local_attention_init(next(keys), cout, dtype).items():
            p[f"{name}.3.{k2}"] = v
        for k2, v in multi_scale_block_init(next(keys), cout, dtype).items():
            p[f"{name}.4.{k2}"] = v

    w, b = kaiming_conv(next(keys), (7, 7, c, 3), dtype=dtype)
    p["output.0.weight"], p["output.0.bias"] = w, b

    w, b = torch_default_linear(next(keys), 4 * c, 4 * c, dtype)
    p["style_encoder.2.weight"], p["style_encoder.2.bias"] = w, b
    return p


def num_transformer_blocks_of(params) -> int:
    n = 0
    while any(k.startswith(f"transformer_blocks.{n}.") for k in params):
        n += 1
    return n


def channels_of(params) -> int:
    """Channel width from the stem kernel, like direct_transform.py:25-30."""
    return params["initial.0.weight"].shape[-1]


def enhanced_generator_apply(params, x, *, window_size: int = 4,
                             fast_attention=False,
                             remat: bool = False,
                             upsample_d2s: bool | None = None):
    """Forward pass. x: (B, H, W, 3) in [-1, 1], H and W divisible by 16.

    Mirrors the reference dataflow (enhanced_generator.py:210-228): stem ->
    two downsample+attention+multiscale stages -> style vector (GAP+Linear) ->
    token flatten -> structural transformer blocks (conditioned on style and
    the raw input) -> two upsample stages -> 7x7 conv + tanh.

    remat=True rematerializes each stage under grad — the equivalent of
    the reference's ``gradient_checkpointing_enable`` (enhanced_generator.py:
    163-209, enabled for CycleGAN training at enhanced_train.py:24-25);
    activations are recomputed in the backward pass instead of stored,
    trading FLOPs for memory exactly like torch.utils.checkpoint.

    fast_attention: False = the XLA formulation everywhere (differentiable,
    the reference); True = the fused LocalAttention kernel on the GPU
    (inference only; see ``local_attention_apply``).

    upsample_d2s: run the up-ladder's ConvTranspose2d(4, 2, 1) as the
    math-exact dense-3x3-conv + depth-to-space rewrite (core.conv.
    conv_transpose2d_d2s). Off by default; not measured on the GPU.
    """
    ckpt = jax.checkpoint if remat else (lambda f: f)
    upsample_d2s = bool(upsample_d2s)

    def down_stage(name):
        def f(params, h):
            h = conv2d(h, params[f"{name}.0.weight"],
                       params[f"{name}.0.bias"], stride=2, padding=1)
            h = in_relu(h)
            h = local_attention_apply(params, h, prefix=f"{name}.3.",
                                      window_size=window_size,
                                      fast=fast_attention)
            return multi_scale_block_apply(params, h, prefix=f"{name}.4.")
        return ckpt(f)

    def up_stage(name):
        def f(params, h):
            if upsample_d2s:
                from ..core.conv import conv_transpose2d_d2s
                h = conv_transpose2d_d2s(h, params[f"{name}.0.weight"],
                                         params[f"{name}.0.bias"])
            else:
                h = conv_transpose2d(h, params[f"{name}.0.weight"],
                                     params[f"{name}.0.bias"], stride=2,
                                     padding=1)
            h = in_relu(h)
            h = local_attention_apply(params, h, prefix=f"{name}.3.",
                                      window_size=window_size,
                                      fast=fast_attention)
            return multi_scale_block_apply(params, h, prefix=f"{name}.4.")
        return ckpt(f)

    orig = x
    h = in_relu(
        conv2d(x, params["initial.0.weight"], params["initial.0.bias"],
               padding=3))

    for name in ("down1", "down2"):
        h = down_stage(name)(params, h)

    B, H, W, C = h.shape
    style = jnp.mean(h, axis=(1, 2))  # GAP
    style = relu(linear(style, params["style_encoder.2.weight"],
                        params["style_encoder.2.bias"]))

    tokens = h.reshape(B, H * W, C)
    for i in range(num_transformer_blocks_of(params)):
        block = ckpt(partial(structural_transformer_apply,
                             grid_hw=(H, W),
                             prefix=f"transformer_blocks.{i}."))
        tokens = block(params, tokens, style, orig)
    h = tokens.reshape(B, H, W, C)

    for name in ("up1", "up2"):
        h = up_stage(name)(params, h)

    h = conv2d(h, params["output.0.weight"], params["output.0.bias"], padding=3)
    return tanh(h)
