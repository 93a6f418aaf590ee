"""Discriminator replay buffer (the CycleGAN paper's 50-image pool).

The reference trains its discriminators on the CURRENT generator fakes only
(enhanced_train.py:66-85); the CycleGAN paper instead samples the D batch
from a history of generated images, which damps the adversarial oscillation
the round-4 trained study measured under the reference recipe
(docs/TRAINED_STUDY.md — validation SSIM peaks then degrades as the
discriminator over-wins). This module is the flag-gated extension
(``--pool_size`` on the train CLI; 0 = reference behavior).

Design: the pool lives ON DEVICE inside the jitted train step —
a fixed-shape ``(pool_size, H, W, 3)`` buffer threaded through the step like
any other state, updated with ``lax.scan`` + dynamic index writes, PRNG from
an explicit key. No host round-trip per step, XLA donates the buffer in
place, and under a data-parallel mesh the replicated-pool update stays
identical on every shard (the sampled batch is a pure function of
(pool, fakes, key)). Per-image law, faithful to the paper's ImagePool:
while the pool is not yet full the fake is inserted and returned as-is;
once full, with p=0.5 the fake is returned (pool untouched), else a uniform
random pool entry is returned and the fake replaces it.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class ImagePool(NamedTuple):
    images: jnp.ndarray  # (pool_size, H, W, 3), model-range values
    n: jnp.ndarray       # int32 scalar, filled count


def pool_init(pool_size: int, image_size: int, dtype=jnp.float32) -> ImagePool:
    """Empty pool. ``dtype`` should match the step's compute dtype so the
    sampled batch feeds the discriminator without a cast."""
    if pool_size <= 0:
        raise ValueError("pool_size must be positive; a zero-capacity pool "
                         "means 'no pool' — pass pools=None instead")
    return ImagePool(
        images=jnp.zeros((pool_size, image_size, image_size, 3), dtype),
        n=jnp.zeros((), jnp.int32))


def pool_sample(pool: ImagePool, fakes: jnp.ndarray, key: Any):
    """Sequentially (scan over the batch, paper order) push each fake
    through the pool law. Returns ``(new_pool, d_batch)`` where ``d_batch``
    has the same shape as ``fakes``.

    Cost note (data-parallel mesh): the scan is sequential over the GLOBAL
    batch and each iteration dynamic-slices the batch-sharded ``fakes``,
    so XLA gathers the fakes to every shard and serializes the update —
    negligible at the deployed batch 8, but linear in global batch and
    adds per-step collectives at pod scale. A pod-scale adopter should
    vectorize the law (single permutation + mask over the batch) if the
    pool update ever shows in profiles."""
    pool_size = pool.images.shape[0]
    if pool_size <= 0:
        raise ValueError("pool_sample on a zero-capacity pool; "
                         "jax.random.randint over an empty range would "
                         "return garbage indices — pass pools=None instead")

    def body(carry, inp):
        images, n = carry
        img, k = inp
        k_use, k_idx = jax.random.split(k)
        idx = jax.random.randint(k_idx, (), 0, pool_size)
        use_hist = jax.random.bernoulli(k_use)          # p = 0.5
        not_full = n < pool_size
        old = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
        out = jnp.where(not_full, img, jnp.where(use_hist, old, img))
        # write position: append slot while filling; the sampled slot when
        # a full pool swaps; a self-overwrite (no-op) when the fake passes
        # straight through.
        pos = jnp.where(not_full, n, idx)
        new_entry = jnp.where(not_full | use_hist, img, old)
        images = jax.lax.dynamic_update_index_in_dim(images, new_entry,
                                                     pos, 0)
        n = jnp.minimum(n + not_full.astype(n.dtype), pool_size)
        return (images, n), out

    keys = jax.random.split(key, fakes.shape[0])
    (images, n), outs = jax.lax.scan(
        body, (pool.images, pool.n), (fakes.astype(pool.images.dtype), keys))
    return ImagePool(images, n), outs
