"""Checkpoint -> ready-to-run generator (direct_transform.py:10-42 parity).

Sniffs the checkpoint flavor (G_AB vs G_BA vs raw), detects the model family
(plain encoder/decoder vs enhanced) and channel width from the weights, and
returns a jitted apply function with a precision policy:

- ``precision='default'``: the backend's default matmul precision (on the
  GPU, float32 convs and matmuls run in TF32 — throughput mode),
- ``precision='highest'``: full float32 arithmetic — required to hit the
  SSIM>=0.99 bit-parity target against PyTorch reference outputs.

The enhanced forward runs LocalAttention through the fused kernel on the
GPU (``fast_attention=True``); its products follow the same precision
policy.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..models import plain_generator_apply, enhanced_generator_apply
from ..weights import (
    load_pth, extract_state_dict, detect_model_kind, detect_channels,
    plain_generator_from_sd, enhanced_generator_from_sd,
)


@dataclass
class LoadedModel:
    kind: str                      # "plain" | "enhanced"
    channels: int
    direction: str | None          # "AB" | "BA" | None (from checkpoint key)
    params: Any
    apply: Callable                # apply(x: (B,H,W,3) in [-1,1]) -> same
    precision: str = "default"


def _sniff_direction(ckpt, prefer: str | None = None) -> str | None:
    if isinstance(ckpt, dict):
        # a dual checkpoint contains BOTH generators: report the one the
        # caller asked for, not whichever key happens to come first
        if prefer and prefer in ckpt and "state_dict" in prefer:
            return "BA" if "BA" in prefer else "AB"
        if "G_AB_state_dict" in ckpt:
            return "AB"
        if "G_BA_state_dict" in ckpt:
            return "BA"
    return None


def load_generator(path, prefer: str | None = None,
                   precision: str = "default") -> LoadedModel:
    """Load any reference-flavor generator checkpoint, auto-detecting
    model type and width (direct_transform.py:10-42 semantics: tries
    G_AB_state_dict first, then G_BA, then a raw state dict)."""
    ckpt = load_pth(path)
    direction = _sniff_direction(ckpt, prefer)
    sd = extract_state_dict(ckpt, prefer=prefer)
    kind = detect_model_kind(sd)
    channels = detect_channels(sd)
    if kind == "plain":
        params = plain_generator_from_sd(sd)
        fwd = plain_generator_apply
    elif kind == "enhanced":
        params = enhanced_generator_from_sd(sd)
        fwd = partial(enhanced_generator_apply, fast_attention=True)
    else:
        raise ValueError(f"checkpoint at {path} is a {kind}, not a generator")

    jax_prec = {"default": None, "high": "high", "highest": "highest"}[precision]

    @jax.jit
    def apply_fn(params, x):
        if jax_prec is None:
            return fwd(params, x)
        with jax.default_matmul_precision(jax_prec):
            return fwd(params, x)

    return LoadedModel(kind=kind, channels=channels, direction=direction,
                       params=params, apply=partial(apply_fn, params),
                       precision=precision)
