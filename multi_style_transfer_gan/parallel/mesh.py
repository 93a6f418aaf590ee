"""Device mesh and sharding helpers (data-parallel, jit-native).

Design (SURVEY.md §7): a 1-D ``data`` mesh is the workhorse — batches shard
over it, parameters replicate, and XLA inserts the gradient all-reduce
automatically when a jitted train step computes a mean loss over a sharded
batch. A second ``model`` axis is available for spatial/tensor sharding
experiments on very large images; at the reference's 256-512^2 resolutions
activations fit one device, so ``model`` defaults to 1. The cards of one
host are joined all to all, so the mesh shape follows the algorithm alone.

Everything goes through ``jax.jit`` + ``NamedSharding`` (not pmap): one
program, any mesh shape, same code on one card, several, or the 8-device
virtual CPU mesh used in tests.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Sequence | None = None,
              shape: tuple[int, int] | None = None,
              axis_names: tuple[str, str] = ("data", "model")) -> Mesh:
    """Build a (data, model) mesh. Default: all devices on the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def make_mesh_for_batch(batch_size: int,
                        devices: Sequence | None = None) -> Mesh:
    """Largest data-parallel mesh whose data axis divides ``batch_size``.

    Single host: dp = gcd(batch, n_devices); devices beyond dp are left
    out rather than producing an un-shardable batch. Multi-host pods
    can't drop devices (every process must own addressable shards for
    ``make_array_from_process_local_data``), so there the batch must
    divide evenly over ALL devices — validated here instead of failing
    deep inside the first prefetch.
    """
    import math

    devices = list(devices if devices is not None else jax.devices())
    if jax.process_count() > 1:
        if batch_size % len(devices):
            raise ValueError(
                f"multi-host: global batch {batch_size} must be divisible "
                f"by the pod's {len(devices)} devices (a partial mesh would "
                f"leave some processes with no addressable shards)")
        return make_mesh(devices, (len(devices), 1))
    dp = math.gcd(max(batch_size, 1), len(devices)) or 1
    return make_mesh(devices[:dp], (dp, 1))


def data_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """Device-put a (pytree of) host array(s) with batch-axis sharding."""
    return jax.tree.map(
        lambda x: jax.device_put(x, data_sharding(mesh, np.ndim(x))), batch)


def replicate_tree(tree, mesh: Mesh):
    rep = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, rep), tree)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis size {n}")
    return global_batch // n
