"""Spatially-sharded high-resolution inference (SURVEY.md §5.7).

At the reference's 256-512^2 resolutions activations fit one chip, so the
framework's workhorse parallelism is data-parallel batch sharding
(``parallel.mesh``). But the generators are resolution-flexible
(direct_transform.py:81-118 sweeps 128-768, and nothing caps it), and at
>=2048^2 the full-resolution NHWC activation stack outgrows one device's
memory. The answer is GSPMD spatial partitioning: shard the image
HEIGHT axis across the mesh, replicate the parameters, and let XLA insert
the halo exchanges for every convolution and the boundary collectives for
the windowed ops — no model-code changes, the same ``*_apply`` functions
run under a height-sharding annotation.

Why this works for these models: every op in both generator families is
either local in H (convs, conv-transposes, 4x4-window attention, window-8
transformer MHSA — halo or block-local under an H shard) or a global
reduction (instance/batch-norm statistics, the style GAP — an XLA
``psum`` over the mesh). XLA's SPMD partitioner generates exactly those
collectives from the sharding annotation; we never hand-write them.

Constraints: H must be divisible by ``16 * n_shards`` (16 = the models'
own stride budget) so every stage's height shards evenly and the window
reshapes stay static. On the GPU the enhanced model's LocalAttention runs
the fused window kernel per height shard under ``jax.shard_map`` (one
kernel launch per shard, replicated weights, zero collectives — the
windows are height-local) while the rest of the model stays
GSPMD-partitioned from the same sharding annotation.

Validated on the 8-virtual-device CPU mesh against the unsharded forward
(tests/test_spatial.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def spatial_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D ``('sp',)`` mesh over the first ``n_devices`` devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("sp",))


def spatial_apply(model, mesh: Mesh | None = None,
                  n_devices: int | None = None):
    """Height-sharded version of ``LoadedModel.apply``.

    Returns ``apply(x)`` taking (B, H, W, 3) in [-1, 1] with H divisible by
    16 * mesh size; the batch stays whole (use ``parallel.mesh`` when you
    have batch to shard — spatial sharding is for when ONE image's
    activations don't fit).
    """
    from ..models import plain_generator_apply, enhanced_generator_apply
    from ..sharding_spec import ShardedFastAttention

    mesh = mesh if mesh is not None else spatial_mesh(n_devices)
    fwd = {"plain": plain_generator_apply,
           "enhanced": partial(enhanced_generator_apply,
                               fast_attention=ShardedFastAttention(
                                   mesh, P(None, "sp"))),
           }[model.kind]
    sp = mesh.shape["sp"]
    x_sharding = NamedSharding(mesh, P(None, "sp", None, None))
    rep = NamedSharding(mesh, P())
    params = jax.tree.map(lambda a: jax.device_put(a, rep), model.params)

    jax_prec = {"default": None, "high": "high",
                "highest": "highest"}[model.precision]

    @partial(jax.jit, out_shardings=x_sharding)
    def run(params, x):
        if jax_prec is None:
            return fwd(params, x)
        with jax.default_matmul_precision(jax_prec):
            return fwd(params, x)

    def apply(x):
        x = jnp.asarray(x)
        h = x.shape[1]
        if h % (16 * sp):
            raise ValueError(
                f"height {h} not divisible by 16 * {sp} mesh shards")
        return run(params, jax.device_put(x, x_sharding))

    return apply
