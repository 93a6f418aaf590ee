"""Marker types that thread sharding intent into model forwards.

Leaf module (imports jax only) so both ``models/*`` and ``parallel/*`` can
depend on it without cycles: the model code dispatches on the marker, the
parallel layer constructs it.
"""

from __future__ import annotations

from typing import NamedTuple

from jax.sharding import Mesh, PartitionSpec


class ShardedFastAttention(NamedTuple):
    """``fast_attention`` value for sharded runs.

    The Pallas window kernel is a per-shard program: under plain GSPMD a
    ``pallas_call`` traced at the GLOBAL shape would force XLA to gather the
    sharded activation onto every device. Windowed channel attention is
    local in the batch and, at the 16-row shard boundaries the spatial path
    guarantees, in the height, so ``jax.shard_map`` runs the same kernel on
    each shard with replicated weights — zero collectives, identical math.
    ``spec`` is how the (B, H, W, C) activation is sharded: P("data") for
    data-parallel batches (pipelines/batch.py), P(None, "sp") for the
    height-sharded spatial path (parallel/spatial.py).

    Hashable (NamedTuple of a Mesh + PartitionSpec) so it can ride in jit
    closures.
    """

    mesh: Mesh
    spec: PartitionSpec
