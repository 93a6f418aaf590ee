"""Masked-inpainting self-supervised pretraining (reference pretrain.py).

Faithful to pretrain.py:99-230: plain Generator(64), Adam(2e-4, betas
0.5/0.999), cosine-annealed LR to 1e-6, global-norm grad clip 1.0, loss =
L1 on dropped patches only, both domains trained each epoch, checkpoints
with model+optimizer+scheduler+epoch every 50 epochs.

The step is one jitted function over a batched, mesh-sharded
batch (the reference runs batch=1); mask generation is on-device from a PRNG
key; the reference's autocast-without-GradScaler quirk (pretrain.py:160-166)
is replaced by an honest dtype policy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..models.enhanced_generator import (
    enhanced_generator_apply, enhanced_generator_init,
)
from ..models.plain_generator import plain_generator_apply, plain_generator_init
from ..data.dataset import random_patch_mask
from .losses import masked_l1

LR = 2e-4             # pretrain.py:99
ETA_MIN = 1e-6        # pretrain.py:131
CLIP_NORM = 1.0       # pretrain.py:165
ADAM_BETAS = (0.5, 0.999)


class PretrainState(NamedTuple):
    params: Any
    opt: Any
    step: jnp.ndarray


def make_pretrain_optimizer(num_epochs: int, steps_per_epoch: int,
                            lr: float = LR):
    """Adam + per-epoch cosine annealing to ETA_MIN + grad clip, matching
    torch CosineAnnealingLR(T_max=num_epochs) stepped once per epoch."""
    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        cos = 0.5 * (1 + jnp.cos(jnp.pi * jnp.minimum(epoch, num_epochs)
                                 / num_epochs))
        return ETA_MIN + (lr - ETA_MIN) * cos

    return optax.chain(
        optax.clip_by_global_norm(CLIP_NORM),
        optax.adam(schedule, b1=ADAM_BETAS[0], b2=ADAM_BETAS[1]),
    )


def pretrain_init_state(key, channels: int = 64, *, num_epochs: int = 200,
                        steps_per_epoch: int = 1000, lr: float = LR,
                        model: str = "plain",
                        num_transformer_blocks: int = 1):
    """model='plain' is the reference recipe (Generator(64), pretrain.py:127).

    model='enhanced' pretrains the EnhancedGenerator itself — a
    completion of the reference's INTENT: enhanced_train.py:28-33
    warm-starts EnhancedGenerator non-strictly from the plain pretrain
    checkpoint, whose keys share nothing, so the reference's warm start
    silently transfers zero tensors. Pretraining the enhanced model
    directly makes the warm start real (measured round 4: CycleGAN from
    scratch at this config spends its first ~5k steps fighting
    reconstruction artifacts the pretrain solves outright)."""
    if model == "enhanced":
        params = enhanced_generator_init(
            key, channels, num_transformer_blocks=num_transformer_blocks)
    else:
        params = plain_generator_init(key, channels)
    tx = make_pretrain_optimizer(num_epochs, steps_per_epoch, lr)
    return PretrainState(params=params, opt=tx.init(params),
                         step=jnp.zeros((), jnp.int32)), tx


def _is_enhanced(params) -> bool:
    """The two generators share no key names (enhanced has the 7x7 stem
    'initial.0.weight'; plain starts at 'encoder.0.weight')."""
    return "initial.0.weight" in params


def pretrain_train_step(state: PretrainState, tx, images, mask_key,
                        compute_dtype=jnp.float32):
    """One step: mask -> generate -> masked L1 -> clip -> adam.

    images: (B, H, W, 3) in [-1, 1]; mask_key: PRNG key for the patch mask.
    Returns (new_state, loss). BatchNorm runs in training mode with running
    stats threaded through params (as torch does).
    """
    B, H, W, _ = images.shape
    mask = random_patch_mask(mask_key, B, H, width=W)
    x = (images * mask).astype(compute_dtype)
    enhanced = _is_enhanced(state.params)

    def loss_fn(params):
        if enhanced:  # stateless forward (InstanceNorm, no running stats)
            gen = enhanced_generator_apply(params, x)
            return masked_l1(gen, images, mask), params
        gen, new_params = plain_generator_apply(params, x, training=True)
        return masked_l1(gen, images, mask), new_params

    (loss, params_with_stats), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(state.params)
    # the running-stat buffer grads are structurally zero (training mode
    # uses batch statistics in the forward), so adam leaves the buffers
    # untouched; their values are overwritten from the forward below
    updates, new_opt = tx.update(grads, state.opt, state.params)
    new_params = optax.apply_updates(state.params, updates)
    # overwrite running stats with the forward-updated buffers
    for k in new_params:
        if k.endswith(("running_mean", "running_var")):
            new_params[k] = params_with_stats[k]
    return PretrainState(new_params, new_opt, state.step + 1), loss


def _map_states(opt, fn):
    """Apply ``fn`` to every optax NamedTuple state node (post-order)."""
    if hasattr(opt, "_fields"):
        opt = type(opt)(*[_map_states(v, fn) for v in opt])
        return fn(opt)
    if isinstance(opt, tuple):
        return tuple(_map_states(v, fn) for v in opt)
    return opt


def restore_opt_state(tx, params, step: int, opt_sd=None, kind="plain"):
    """Rebuild the optax state for a resume at ``step``.

    The reference restores the torch optimizer+scheduler
    (pretrain_resume.py:134-157); the equivalent here is a fresh init with
    every ``count`` fast-forwarded (adam bias correction + the LR
    schedule, which reads optax's internal count — NOT PretrainState.step)
    and, when the checkpoint carries a torch-schema Adam state, the
    exp_avg/exp_avg_sq moments restored into mu/nu.
    """
    opt = tx.init(params)
    c = jnp.asarray(step, jnp.int32)
    opt = _map_states(opt, lambda s: s._replace(count=c)
                      if "count" in s._fields else s)
    if opt_sd and isinstance(opt_sd.get("state"), dict) and opt_sd["state"]:
        from ..weights import adam_state_from_torch

        mu, nu, _ = adam_state_from_torch(opt_sd, params, kind)
        opt = _map_states(
            opt, lambda s: s._replace(mu=mu, nu=nu)
            if "mu" in s._fields and "nu" in s._fields else s)
    return opt


def save_pretrain_checkpoint(state: PretrainState, path, epoch: int,
                             loss: float = 0.0, tx_lr: float = LR):
    """Reference checkpoint schema (pretrain.py:210-216), torch-loadable:
    model_state_dict includes the BatchNorm num_batches_tracked buffers
    and optimizer_state_dict is a real torch.optim.Adam state dict
    (state/param_groups with exp_avg/exp_avg_sq from the optax moments),
    so the reference's pretrain_resume.py can resume from our output."""
    import numpy as np

    from ..weights import adam_state_to_torch, params_to_torch_sd, save_pth

    kind = "enhanced" if _is_enhanced(state.params) else "plain"
    model_sd = params_to_torch_sd(state.params, kind)
    for k in list(model_sd):
        if k.endswith("running_mean"):
            model_sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                np.asarray(int(state.step), np.int64)

    adam = None
    def grab(s):
        nonlocal adam
        if "mu" in getattr(s, "_fields", ()) and "nu" in s._fields:
            adam = s
        return s
    _map_states(state.opt, grab)
    opt_sd = (adam_state_to_torch(state.params, adam.mu, adam.nu,
                                  int(adam.count), kind, tx_lr,
                                  ADAM_BETAS)
              if adam is not None else {"step": int(state.step)})

    save_pth({
        "epoch": epoch,
        "model_state_dict": model_sd,
        "optimizer_state_dict": opt_sd,
        "scheduler_state_dict": {"last_epoch": epoch},
        "loss": float(loss),
    }, path)
