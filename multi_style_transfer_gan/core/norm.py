"""Normalization primitives with PyTorch-default semantics on NHWC data.

Reference usage (see SURVEY.md §2.1):
- ``nn.InstanceNorm2d(C)`` everywhere in the enhanced models — PyTorch default
  is affine=False, track_running_stats=False, eps=1e-5, i.e. a *stateless*
  per-(sample, channel) normalization (enhanced_generator.py:93 etc.).
- ``nn.BatchNorm2d(C)`` in the plain CycleGAN generator (pretrain.py:69-89) —
  affine=True with running stats; inference uses running stats, training uses
  batch stats with momentum-0.1 running updates.
- ``nn.utils.spectral_norm`` on every discriminator conv
  (enhanced_generator.py:269-271) — one step of power iteration per forward.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp


def instance_norm(x, *, eps=1e-5, weight=None, bias=None):
    """InstanceNorm2d with PyTorch defaults (affine=False unless given).

    x: (B, H, W, C); normalizes each (sample, channel) plane over H, W.
    Uses biased variance, like PyTorch. Statistics computed in fp32 for
    bf16 stability, result cast back to x.dtype.
    """
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=(1, 2), keepdims=True)
    out = (xf - mean) * jax.lax.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.astype(jnp.float32)
    if bias is not None:
        out = out + bias.astype(jnp.float32)
    return out.astype(x.dtype)


def instance_norm_onepass(x, *, eps=1e-5):
    """InstanceNorm2d with E[x^2]-E[x]^2 statistics — ONE read for stats.

    Same math as :func:`instance_norm` up to fp32 rounding: the default
    two-pass form (mean, then centered variance) forces XLA to read the
    tensor twice before the normalize pass, because the second reduction
    depends on the first. Computing sum(x) and sum(x^2) in one fused
    reduction halves the stat-read traffic of every InstanceNorm in the
    HBM-bound generator (13 of them). Catastrophic cancellation is a
    non-issue at these scales: activations are O(1) with means O(0.1),
    and both accumulations are fp32 (inputs bf16); var is clamped at 0.
    Divergence vs the two-pass form sits at the bf16 noise floor.
    """
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    meansq = jnp.mean(jnp.square(xf), axis=(1, 2), keepdims=True)
    var = jnp.maximum(meansq - jnp.square(mean), 0.0)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


def _in_act_fwd_math(x, eps, slope):
    """One-pass IN -> (leaky-)ReLU; returns (out, xhat, rstd) in fp32."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    meansq = jnp.mean(jnp.square(xf), axis=(1, 2), keepdims=True)
    var = jnp.maximum(meansq - jnp.square(mean), 0.0)
    rstd = jax.lax.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    out = jnp.where(xhat > 0, xhat, slope * xhat)  # slope=0 -> exact ReLU
    return out, xhat, rstd


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _in_act(x, eps, slope):
    out, _, _ = _in_act_fwd_math(x, eps, slope)
    return out.astype(x.dtype)


def _in_act_fwd(x, eps, slope):
    out, xhat, rstd = _in_act_fwd_math(x, eps, slope)
    # Residuals: xhat in the INPUT dtype (bf16 in the train fast path — one
    # tensor instead of autodiff's x + several reduction residuals) + the
    # tiny (B,1,1,C) rstd. The activation mask is recomputed from xhat.
    return out.astype(x.dtype), (xhat.astype(x.dtype), rstd)


def _in_act_bwd(eps, slope, res, dy):
    xhat, rstd = res
    xh = xhat.astype(jnp.float32)
    g = dy.astype(jnp.float32)
    g = g * jnp.where(xh > 0, 1.0, slope)  # (leaky-)ReLU backward
    # d/dx of xhat = (x - mean)*rstd with biased-variance stats:
    #   dx = rstd * (g - mean_HW(g) - xhat * mean_HW(g * xhat))
    gm = jnp.mean(g, axis=(1, 2), keepdims=True)
    gxm = jnp.mean(g * xh, axis=(1, 2), keepdims=True)
    dx = rstd * (g - gm - xh * gxm)
    return (dx.astype(xhat.dtype),)


_in_act.defvjp(_in_act_fwd, _in_act_bwd)


# Trace-time implementation switch for in_relu / in_leaky_relu:
#   "fused"     one-pass stats + hand-written VJP (_in_act)
#   "reference" two-pass instance_norm + plain activation, XLA autodiff
# Parity pinned in tests/test_core_parity.py; not yet timed on the GPU. Flip the module global (or use the
# MSTGAN_REFERENCE_IN=1 env var read at import) before TRACING — jitted
# programs bake the choice in.
IN_ACT_IMPL = "reference" if os.environ.get("MSTGAN_REFERENCE_IN") == "1" \
    else "fused"


def in_relu(x, *, eps=1e-5):
    """Fused ``relu(instance_norm(x))`` with a hand-written VJP.

    Forward: one-pass fp32 stats (see :func:`instance_norm_onepass`) +
    normalize + ReLU — XLA fuses this into one stats read and one
    normalize pass. Backward: ONE elementwise pass + two fused reductions
    over (dy, xhat) instead of autodiff's mean/var chain-rule graph, and
    the only full-tensor residual is xhat (autodiff additionally keeps x
    and the centered intermediate alive). This is the generator's
    ubiquitous norm+activation (13 sites) — the conv/IN backward stack the
    train profile names as the residual.

    Dtype gate (same convention as the attention kernels' parity split):
    fp32 inputs take the reference two-pass + autodiff path — the one-pass
    stats compound to ~2e-3 across the generator's 13 INs, above the 5e-4
    torch-import parity bar — while bf16/f16 inputs (the production
    compute dtype, quantization floor ~8e-3) take the fused path.
    """
    if IN_ACT_IMPL == "fused" and x.dtype != jnp.float32:
        return _in_act(x, eps, 0.0)
    return jnp.maximum(instance_norm(x, eps=eps), 0)


def in_leaky_relu(x, slope=0.2, *, eps=1e-5):
    """Fused ``leaky_relu(instance_norm(x), slope)`` — discriminator flavor."""
    if IN_ACT_IMPL == "fused" and x.dtype != jnp.float32:
        return _in_act(x, eps, slope)
    y = instance_norm(x, eps=eps)
    return jnp.where(y > 0, y, slope * y)


def batch_norm(x, running_mean, running_var, weight, bias, *,
               training=False, momentum=0.1, eps=1e-5):
    """BatchNorm2d matching PyTorch semantics.

    x: (B, H, W, C). In eval mode normalizes with running stats. In training
    mode normalizes with biased batch stats and returns updated running stats
    (running update uses the *unbiased* variance, as PyTorch does).

    Returns:
      (out, new_running_mean, new_running_var) — running stats pass through
      unchanged in eval mode.
    """
    xf = x.astype(jnp.float32)
    if training:
        mean = jnp.mean(xf, axis=(0, 1, 2))
        var = jnp.mean(jnp.square(xf - mean), axis=(0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean.astype(jnp.float32), running_var.astype(jnp.float32)
        new_mean, new_var = running_mean, running_var
    out = (xf - mean) * jax.lax.rsqrt(var + eps)
    out = out * weight.astype(jnp.float32) + bias.astype(jnp.float32)
    return out.astype(x.dtype), new_mean, new_var


def spectral_normalize(w_orig, u, v=None, *, n_power_iterations=1, eps=1e-12,
                       update=True):
    """Spectral normalization of a conv kernel, PyTorch-compatible.

    PyTorch's ``nn.utils.spectral_norm`` reshapes the OIHW weight to
    (O, I*kh*kw) and runs power iteration with persistent ``u`` (O,) /
    ``v`` (I*kh*kw,) buffers; the effective weight is W / sigma.

    Here ``w_orig`` is HWIO (our layout); we reshape to (O, H*W*I) —
    the same matrix up to a column permutation, which leaves sigma (and the
    u vector) identical, so imported torch ``weight_u`` buffers stay valid.

    Args:
      w_orig: (kh, kw, I, O) unnormalized kernel.
      u: (O,) persistent left singular vector estimate.
      v: optional (I*kh*kw,)-equivalent right vector. In eval mode
        (update=False) a stored torch ``weight_v`` gives exact parity with
        ``model.eval()``, which reuses both buffers without iterating.
        NOTE: a torch ``weight_v`` is ordered for the (O, I*kh*kw) reshape of
        the OIHW weight; ours is the (O, H*W*I) reshape — permuted orders.
        The importer converts (see weights.torch_import._convert_weight_v).
      update: if False (eval), no power iteration runs.

    Returns:
      (w_normalized, new_u, new_v)
    """
    o = w_orig.shape[-1]
    mat = jnp.transpose(w_orig.reshape(-1, o)).astype(jnp.float32)  # (O, HWI)

    def _l2n(x):
        return x / (jnp.linalg.norm(x) + eps)

    uu = u.astype(jnp.float32)
    if update:
        if v is None and n_power_iterations < 1:
            v = _l2n(mat.T @ uu)  # initialize like the first iteration
        for _ in range(n_power_iterations):
            v = _l2n(mat.T @ uu)
            uu = _l2n(mat @ v)
        uu = jax.lax.stop_gradient(uu)
        v = jax.lax.stop_gradient(v)
    elif v is None:
        v = _l2n(mat.T @ uu)
    else:
        v = v.astype(jnp.float32)
    sigma = uu @ (mat @ v)
    return (w_orig / sigma).astype(w_orig.dtype), uu.astype(u.dtype), v


def l2_normalize(u, eps: float = 1e-12):
    """Zero-safe F.normalize over the last axis (fp32 result).

    A position whose vector is exactly 0 must yield 0 with FINITE
    gradients — naive x/sqrt(sum(x^2)) NaNs the backward pass there. This
    is the parity-critical normalize of the windowed channel attention
    (enhanced_generator.py:6-47 reference); the Pallas kernels re-derive
    the same guard in-kernel.
    """
    uf = u.astype(jnp.float32)
    sumsq = jnp.sum(jnp.square(uf), axis=-1, keepdims=True)
    zero = sumsq == 0
    n = jnp.sqrt(jnp.where(zero, 1.0, sumsq))
    n = jnp.where(zero, 0.0, n)
    return uf / jnp.maximum(n, eps)
