"""Input pipeline tests (data/dataset.py): folder convention, batching,
the multi-host process-sharded path, and the inpainting mask law."""

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from multi_style_transfer_gan.data import (
    ImageFolderDataset, prefetch_to_device, random_patch_mask,
)
from multi_style_transfer_gan.parallel import make_mesh, data_sharding


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("m2p")
    d = root / "trainA"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        arr = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
        # constant-tag the first pixel so images are identifiable post-crop
        arr[:, :, 0] = i * 11
        Image.fromarray(arr).save(d / f"a{i}.jpg")
    return root


def test_folder_convention_and_stacking(data_root):
    ds = ImageFolderDataset(data_root, "A", img_size=32, host_size=32)
    assert len(ds) == 8
    (batch,) = list(ds.batches(8, shuffle=False, epochs=1))
    assert batch.shape == (8, 32, 32, 3) and batch.dtype == np.uint8


def test_process_sharded_batches_partition(data_root):
    """Two simulated processes: same seed => disjoint strided slices whose
    union is exactly the single-process global batch."""
    ds = ImageFolderDataset(data_root, "A", img_size=32, host_size=32)
    kw = dict(shuffle=True, seed=3, epochs=1)
    (full,) = list(ds.batches(8, **kw))
    (p0,) = list(ds.batches(8, process_index=0, process_count=2, **kw))
    (p1,) = list(ds.batches(8, process_index=1, process_count=2, **kw))
    assert p0.shape == p1.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(np.concatenate([p0, p1]),
                                  np.concatenate([full[0::2], full[1::2]]))


def test_process_count_must_divide_batch(data_root):
    ds = ImageFolderDataset(data_root, "A", img_size=32, host_size=32)
    with pytest.raises(ValueError, match="divisible"):
        next(ds.batches(7, process_count=2))


def test_prefetch_multihost_assembly():
    """Single-process multihost mode: make_array_from_process_local_data
    must reproduce the device_put global array."""
    mesh = make_mesh(jax.devices()[:4], (4, 1))
    sharding = data_sharding(mesh)
    x = np.arange(4 * 2 * 2 * 3, dtype=np.float32).reshape(4, 2, 2, 3)
    (got,) = list(prefetch_to_device(iter([x]), sharding, multihost=True))
    assert got.sharding == sharding
    np.testing.assert_array_equal(np.asarray(got), x)


def test_prefetch_multihost_requires_sharding():
    with pytest.raises(ValueError, match="sharding"):
        list(prefetch_to_device(iter([np.zeros((4, 2))]), None,
                                multihost=True))


def test_random_patch_mask_law():
    mask = random_patch_mask(jax.random.PRNGKey(0), 64, img_size=64, grid=8,
                             p=0.4)
    assert mask.shape == (64, 64, 64, 1)
    # piecewise-constant on the 8x8 grid of 8px patches
    m = np.asarray(mask)[..., 0].reshape(64, 8, 8, 8, 8)
    assert (m == m[:, :, :1, :, :1]).all()
    keep = m[:, :, 0, :, 0].mean()
    assert 0.55 < keep < 0.65  # E[keep] = 0.6


def test_make_mesh_for_batch_multihost_validation(monkeypatch):
    # multi-host pods must not silently drop devices (every process needs
    # addressable shards for make_array_from_process_local_data)
    from multi_style_transfer_gan.parallel import make_mesh_for_batch

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="divisible"):
        make_mesh_for_batch(12, devices=jax.devices())  # 12 % 8 != 0
    mesh = make_mesh_for_batch(16, devices=jax.devices())
    assert mesh.shape["data"] == 8  # full pod, no dropped devices
