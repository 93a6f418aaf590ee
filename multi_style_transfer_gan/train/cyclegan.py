"""CycleGAN trainer — the reference's EnhancedCycleGAN as one jitted step.

Faithful to enhanced_train.py:13-131:
- G_AB/G_BA = EnhancedGenerator(16, 1); D_A/D_B = EnhancedDiscriminator(16)
- Adam(G) lr=5e-5, Adam(D) lr=2e-4, betas (0.5, 0.999)
- D phase first (LSGAN real->1 / detached fake->0, each pair averaged), then
  the G phase runs against the *updated* discriminators (torch steps
  d_optimizer before building the G loss, enhanced_train.py:85-99)
- G loss = GAN + 10*cycle + 2*identity + 0.5*structure
  (structure = L1 between D structure-head maps of real vs fake)

Deviations (documented, math-intent preserving):
- mixed precision is a dtype policy (bf16 compute / fp32 params+opt) instead
  of torch.cuda.amp GradScaler — bf16 needs no loss scaling;
- spectral-norm u/v run one power iteration per step (the reference's
  in-place torch buffers iterate on every D forward — several per step —
  an incidental artifact of module reuse, not a design choice);
- the whole step is one XLA program: with the batch sharded over the mesh's
  ``data`` axis and params replicated, jit inserts the gradient all-reduce
  automatically. The reference trains batch=1 single-GPU.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..models.enhanced_generator import (
    enhanced_generator_apply, enhanced_generator_init,
)
from ..models.discriminator import discriminator_apply, discriminator_init
from .losses import l1_loss, lsgan_loss

LAMBDA_CYCLE = 10.0     # enhanced_train.py:55
LAMBDA_IDENTITY = 2.0   # enhanced_train.py:56
LAMBDA_STRUCTURE = 0.5  # enhanced_train.py:57
G_LR = 5e-5             # enhanced_train.py:38
D_LR = 2e-4             # enhanced_train.py:42
ADAM_BETAS = (0.5, 0.999)


class CycleGANState(NamedTuple):
    g_params: Any        # {"G_AB": ..., "G_BA": ...}
    d_params: Any        # {"D_A": ..., "D_B": ...}
    sn_state: Any        # {"D_A": ..., "D_B": ...}
    g_opt: Any
    d_opt: Any
    step: jnp.ndarray


def make_optimizers(g_lr: float = G_LR, d_lr: float = D_LR,
                    decay_steps: int | None = None,
                    decay_start: int | None = None):
    """Adam pair, reference learning rates (enhanced_train.py:36-43).

    decay_steps/decay_start (both None by default = the reference's
    constant-LR recipe): linear decay to zero from ``decay_start`` to
    ``decay_steps`` — the CycleGAN paper's schedule (constant for the
    first half, linear-to-zero for the second). Flag-gated extension:
    the round-4 trained study measured late-phase adversarial drift
    under constant LRs (validation SSIM peaks ~epoch 100-160, then the
    discriminator over-wins and quality degrades — docs/TRAINED_STUDY
    .md); the standard remedy is exactly this schedule.
    """
    def _sched(lr):
        if decay_steps is None:
            return lr
        start = decay_start if decay_start is not None else decay_steps // 2
        return optax.schedules.join_schedules(
            [optax.constant_schedule(lr),
             optax.linear_schedule(lr, 0.0, max(decay_steps - start, 1))],
            [start])

    g_tx = optax.adam(_sched(g_lr), b1=ADAM_BETAS[0], b2=ADAM_BETAS[1])
    d_tx = optax.adam(_sched(d_lr), b1=ADAM_BETAS[0], b2=ADAM_BETAS[1])
    return g_tx, d_tx


def cyclegan_init_state(key, channels: int = 16, num_transformer_blocks: int = 1,
                        pretrained_params=None, g_lr: float = G_LR,
                        d_lr: float = D_LR, txs=None) -> CycleGANState:
    """Build fresh G/D params (optionally warm-starting both generators from
    masked-pretrain weights non-strictly, enhanced_train.py:28-33)."""
    kab, kba, kda, kdb = jax.random.split(key, 4)
    g_ab = enhanced_generator_init(kab, channels, num_transformer_blocks)
    g_ba = enhanced_generator_init(kba, channels, num_transformer_blocks)
    if pretrained_params:
        # non-strict load: only keys that exist with matching shapes.
        # NOTE reference parity: the reference warm-starts EnhancedGenerator
        # from the PLAIN pretrain checkpoint with strict=False
        # (enhanced_train.py:28-33) — the two models share ZERO key names,
        # so the reference's warm start transfers nothing; the count below
        # makes that visible instead of silent.
        transferred = 0
        for tgt in (g_ab, g_ba):
            for k, v in pretrained_params.items():
                if k in tgt and tgt[k].shape == v.shape:
                    tgt[k] = v
                    transferred += 1
        print(f"warm start: {transferred} tensors transferred"
              + (" (the reference's plain->enhanced warm start also "
                 "matches zero keys)" if transferred == 0 else ""))
    d_a_params, d_a_sn = discriminator_init(kda, channels)
    d_b_params, d_b_sn = discriminator_init(kdb, channels)
    g_params = {"G_AB": g_ab, "G_BA": g_ba}
    d_params = {"D_A": d_a_params, "D_B": d_b_params}
    sn_state = {"D_A": d_a_sn, "D_B": d_b_sn}
    # txs: the EXACT optimizer pair the train loop will step with — a
    # scheduled adam carries a count in its state tree, so initializing
    # with a mismatched (constant-LR) pair breaks tx.update at step 1
    g_tx, d_tx = txs if txs is not None else make_optimizers(g_lr, d_lr)
    return CycleGANState(
        g_params=g_params, d_params=d_params, sn_state=sn_state,
        g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params),
        step=jnp.zeros((), jnp.int32))


def cyclegan_train_step(state: CycleGANState, real_A, real_B,
                        g_tx, d_tx, *, compute_dtype=jnp.float32,
                        remat=True, extra_g_loss=None, pools=None):
    """One full CycleGAN step. real_A/real_B: (B, H, W, 3) in [-1, 1].

    Returns (new_state, losses_dict) — losses match the reference's returned
    dict keys (enhanced_train.py:125-131). remat=True rematerializes
    generator stages in the backward pass — the reference enables gradient
    checkpointing for CycleGAN training (enhanced_train.py:24-25). The
    math is identical either way; the train CLI defaults to remat off and
    exposes --remat for memory-bound runs; the function default stays True
    (safe for arbitrary callers). Generators run the XLA formulation
    throughout, which autodiff differentiates.
    extra_g_loss: optional callable (the train/perceptual.py hook)
    ``f(fake_A, fake_B, real_A, real_B) -> scalar`` added to the G loss
    (differentiated through the generators) — NOT part of the reference's
    loss set.
    pools: optional ``((pool_A, pool_B), key)`` — train/pool.py replay
    buffers (the CycleGAN paper's image pool; NOT in the reference, which
    scores D on current fakes only, enhanced_train.py:66-85). When given,
    the D phase scores pool-sampled fakes instead of the current ones (the
    G phase is unchanged) and the return becomes
    ``(new_state, losses, (new_pools, new_key))``.
    """
    gen = partial(enhanced_generator_apply, remat=remat)
    xa = real_A.astype(compute_dtype)
    xb = real_B.astype(compute_dtype)

    def d_pair(d_params_dir, sn, real, fake, update_sn):
        """(real, fake) through one discriminator; returns scores/maps per
        half and the new sn state. The fake pass normalizes with the real
        pass's post-iteration u/v, so both see the same effective W."""
        r, rm, sn2 = discriminator_apply(d_params_dir, sn, real,
                                         update_sn=update_sn)
        f, fm, _ = discriminator_apply(d_params_dir, sn2, fake,
                                       update_sn=False)
        return r, f, rm, fm, sn2

    # fakes for the D phase (values only — stop_gradient = .detach())
    fake_B0 = gen(state.g_params["G_AB"], xa)
    fake_A0 = gen(state.g_params["G_BA"], xb)
    fake_B0 = jax.lax.stop_gradient(fake_B0)
    fake_A0 = jax.lax.stop_gradient(fake_A0)
    new_pools = None
    if pools is not None:
        from .pool import pool_sample

        (pool_a, pool_b), pkey = pools
        pkey, ka, kb = jax.random.split(pkey, 3)
        pool_a, fake_A0 = pool_sample(pool_a, fake_A0, ka)
        pool_b, fake_B0 = pool_sample(pool_b, fake_B0, kb)
        fake_A0 = fake_A0.astype(compute_dtype)
        fake_B0 = fake_B0.astype(compute_dtype)
        new_pools = ((pool_a, pool_b), pkey)

    # ---------------- discriminator phase ----------------
    def d_loss_fn(d_params):
        ra, fa, _, _, sn_a = d_pair(d_params["D_A"], state.sn_state["D_A"],
                                    xa, fake_A0, update_sn=True)
        rb, fb, _, _, sn_b = d_pair(d_params["D_B"], state.sn_state["D_B"],
                                    xb, fake_B0, update_sn=True)
        d_real = (lsgan_loss(ra, 1.0) + lsgan_loss(rb, 1.0)) * 0.5
        d_fake = (lsgan_loss(fa, 0.0) + lsgan_loss(fb, 0.0)) * 0.5
        loss = d_real + d_fake
        return loss, {"D_A": sn_a, "D_B": sn_b}

    (d_loss, new_sn), d_grads = jax.value_and_grad(
        d_loss_fn, has_aux=True)(state.d_params)
    d_updates, new_d_opt = d_tx.update(d_grads, state.d_opt, state.d_params)
    new_d_params = optax.apply_updates(state.d_params, d_updates)

    # ---------------- generator phase (vs updated D) ----------------
    def g_loss_fn(g_params):
        # the reference's call-per-tensor ordering (enhanced_train.py:88-118)
        fake_B = gen(g_params["G_AB"], xa)
        idt_B = gen(g_params["G_AB"], xb)
        fake_A = gen(g_params["G_BA"], xb)
        idt_A = gen(g_params["G_BA"], xa)
        identity = (l1_loss(idt_A, xa) + l1_loss(idt_B, xb)) * LAMBDA_IDENTITY

        recon_A = gen(g_params["G_BA"], fake_B)
        recon_B = gen(g_params["G_AB"], fake_A)
        cycle = (l1_loss(recon_A, xa) + l1_loss(recon_B, xb)) * LAMBDA_CYCLE

        _, fa, ra_map, fa_map, _ = d_pair(new_d_params["D_A"], new_sn["D_A"],
                                          xa, fake_A, update_sn=False)
        _, fb, rb_map, fb_map, _ = d_pair(new_d_params["D_B"], new_sn["D_B"],
                                          xb, fake_B, update_sn=False)
        gan = lsgan_loss(fa, 1.0) + lsgan_loss(fb, 1.0)
        structure = (l1_loss(ra_map, fa_map)
                     + l1_loss(rb_map, fb_map)) * LAMBDA_STRUCTURE

        total = gan + cycle + identity + structure
        if extra_g_loss is not None:
            total = total + extra_g_loss(fake_A, fake_B, xa, xb)
        return total, (gan, cycle, identity, structure)

    (g_total, (gan, cycle, identity, structure)), g_grads = jax.value_and_grad(
        g_loss_fn, has_aux=True)(state.g_params)
    g_updates, new_g_opt = g_tx.update(g_grads, state.g_opt, state.g_params)
    new_g_params = optax.apply_updates(state.g_params, g_updates)

    new_state = CycleGANState(
        g_params=new_g_params, d_params=new_d_params, sn_state=new_sn,
        g_opt=new_g_opt, d_opt=new_d_opt, step=state.step + 1)
    losses = {
        "d_loss": d_loss, "g_loss": gan, "cycle_loss": cycle,
        "identity_loss": identity, "structure_loss": structure,
    }
    if pools is not None:
        return new_state, losses, new_pools
    return new_state, losses


def make_train_step(g_tx, d_tx, *, compute_dtype=jnp.bfloat16,
                    remat: bool = False, pools: bool = False):
    """The train CLI's jitted step: ``step(state, a, b)`` or, with
    ``pools``, ``step(state, pools, a, b)``, on uint8 (B, H, W, 3) batches.

    Inputs cross to the device as uint8 and are normalized inside the
    program (4x less H2D than float32, and no eager ops on the loop). The
    state, and the pool buffers, are donated: XLA updates params,
    optimizer moments, spectral-norm buffers and pool entries in place
    instead of allocating a second copy each step.
    """
    from ..ops import to_model_range

    def step(state, pool_state, a, b):
        return cyclegan_train_step(
            state, to_model_range(a), to_model_range(b), g_tx, d_tx,
            compute_dtype=compute_dtype, remat=remat, pools=pool_state)

    if pools:
        return jax.jit(step, donate_argnums=(0, 1))
    return jax.jit(lambda s, a, b: step(s, None, a, b), donate_argnums=0)


def save_models(state: CycleGANState, save_dir, epoch: int):
    """Write the reference's three .pth files (enhanced_train.py:133-152):
    G_AB_epoch_N / G_BA_epoch_N / discriminators_epoch_N — loadable by the
    PyTorch reference."""
    from pathlib import Path

    from ..weights import params_to_torch_sd, save_pth

    save_dir = Path(save_dir)
    save_pth({"epoch": epoch,
              "G_AB_state_dict": params_to_torch_sd(
                  state.g_params["G_AB"], "enhanced")},
             save_dir / f"G_AB_epoch_{epoch}.pth")
    save_pth({"epoch": epoch,
              "G_BA_state_dict": params_to_torch_sd(
                  state.g_params["G_BA"], "enhanced")},
             save_dir / f"G_BA_epoch_{epoch}.pth")

    import numpy as np

    def d_sd(name):
        sd = params_to_torch_sd(state.d_params[name], "discriminator")
        for conv, st in state.sn_state[name].items():
            sd[f"{conv}.weight_u"] = jnp.asarray(st["u"])
            # our v is in (kh, kw, I) flat order; export torch's (I, kh, kw)
            w = np.asarray(state.d_params[name][f"{conv}.weight_orig"],
                           np.float32)
            kh, kw, i, _ = w.shape
            if st["v"] is not None:
                v = np.asarray(st["v"]).reshape(kh, kw, i)
            else:
                # pre-power-iteration state: synthesize v the way the first
                # iteration would (v = normalize(W^T u)) so torch can
                # strict-load (spectral_norm registers weight_v)
                v_flat = w.reshape(-1, w.shape[-1]) @ np.asarray(st["u"],
                                                                 np.float32)
                v = (v_flat / max(np.linalg.norm(v_flat), 1e-12)
                     ).reshape(kh, kw, i)
            sd[f"{conv}.weight_v"] = np.ascontiguousarray(
                v.transpose(2, 0, 1).reshape(-1))
        return sd

    save_pth({"epoch": epoch,
              "D_A_state_dict": d_sd("D_A"),
              "D_B_state_dict": d_sd("D_B")},
             save_dir / f"discriminators_epoch_{epoch}.pth")
