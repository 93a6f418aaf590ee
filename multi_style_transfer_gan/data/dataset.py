"""Datasets and input pipeline.

Capability parity with the reference's ``MonetPhotoDataset`` (pretrain.py:
20-57): the ``{split}{domain}`` folder convention over monet2photo, Resize +
CenterCrop(256) + Normalize(0.5) transform, and the random 8x8-grid
inpainting mask (each 32x32 patch dropped with p=0.4, pretrain.py:47-56).

Departures (SURVEY.md §3.2 — the reference feeds batch=1 with
num_workers<=1 and a serial python loop):
- batches are real (N-image) arrays, assembled on the host by a thread pool
  and handed to the device asynchronously (``prefetch_to_device``) so the
  device never waits on JPEG decode;
- the resize/crop/normalize transform runs *on device* (ops.image) inside
  the jitted step — the host only decodes to uint8;
- mask generation is a jittable function of a PRNG key (same Bernoulli(0.4)
  per-patch law), so the whole train step including augmentation is one XLA
  program.
"""

from __future__ import annotations

import os
import glob as _glob
import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

import jax
import jax.numpy as jnp

_EXTS = ("jpg", "jpeg", "png", "bmp")


def list_images(directory, exts: Sequence[str] = _EXTS) -> list[str]:
    """Glob like batch_process_images.py:469-473 (both cases), sorted."""
    files: list[str] = []
    for ext in exts:
        files.extend(_glob.glob(os.path.join(str(directory), f"*.{ext}")))
        files.extend(_glob.glob(os.path.join(str(directory), f"*.{ext.upper()}")))
    return sorted(set(files))


class ImageFolderDataset:
    """monet2photo-style folder dataset: ``root/{split}{domain}/*.{jpg,png}``.

    Yields decoded uint8 HWC numpy images (pre-resized on host to a common
    ``host_size`` so batches stack; the exact model transform happens on
    device).
    """

    def __init__(self, root, domain: str, split: str = "train",
                 img_size: int = 256, host_size: int | None = None):
        self.root = Path(root)
        self.domain = domain
        self.split = split
        self.img_size = img_size
        # decode-time size: keep shorter side at img_size so the on-device
        # Resize+CenterCrop sees the same content PIL would.
        self.host_size = host_size
        folder = self.root / f"{split}{domain}"
        self.image_paths = list_images(folder, ("jpg", "png"))

    def __len__(self):
        return len(self.image_paths)

    def load(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.image_paths[idx]).convert("RGB")
        if self.host_size:
            # shorter-side resize on host (cheap, keeps aspect) — the
            # device-side center-crop finishes the transform
            w, h = img.size
            s = self.host_size / min(w, h)
            img = img.resize((max(1, round(w * s)), max(1, round(h * s))),
                             Image.LANCZOS)
        return np.asarray(img, np.uint8)

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 42, drop_last: bool = True,
                epochs: int | None = None, process_index: int = 0,
                process_count: int = 1) -> Iterator[np.ndarray]:
        """Yield stacked uint8 batches (requires host_size for stacking,
        or images of uniform size).

        ``batch_size`` is the GLOBAL batch. On a multi-host pod pass
        ``process_index/process_count`` (defaults = single host): every
        process shuffles with the same seed, so the strided slice
        ``idxs[process_index::process_count]`` partitions each global batch
        disjointly and each host only decodes its own images. Feed the
        local batches through ``prefetch_to_device`` (multihost mode) to
        assemble the global sharded array.
        """
        if batch_size % max(process_count, 1):
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"process count {process_count}")
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order), batch_size):
                idxs = order[i:i + batch_size]
                if drop_last and len(idxs) < batch_size:
                    continue
                local = idxs[process_index::process_count]
                imgs = [self._square(self.load(j)) for j in local]
                yield np.stack(imgs)
            epoch += 1

    def _square(self, img: np.ndarray) -> np.ndarray:
        """Host center-crop to (img_size, img_size) so batches stack; the
        shorter-side resize already happened in load()."""
        if self.host_size is None:
            return img
        h, w = img.shape[:2]
        s = self.img_size
        top = max(0, (h - s) // 2)
        left = max(0, (w - s) // 2)
        out = img[top:top + s, left:left + s]
        if out.shape[:2] != (s, s):  # tiny source: pad
            out = np.pad(out, ((0, s - out.shape[0]), (0, s - out.shape[1]),
                               (0, 0)), mode="edge")
        return out


def random_patch_mask(key, batch_size: int, img_size: int = 256,
                      grid: int = 8, p: float = 0.4,
                      width: int | None = None):
    """The reference's inpainting mask (pretrain.py:47-56), batched + jittable.

    Returns (B, img_size, width or img_size, 1) float mask: 1 = keep, 0 =
    dropped patch, each grid cell dropped i.i.d. with probability ``p``.
    """
    w = width if width is not None else img_size
    if img_size % grid or w % grid:
        raise ValueError(f"mask size {img_size}x{w} not divisible by the "
                         f"{grid}x{grid} patch grid")
    keep = jax.random.bernoulli(key, 1.0 - p, (batch_size, grid, grid))
    keep = keep.astype(jnp.float32)
    mask = jnp.repeat(jnp.repeat(keep, img_size // grid, axis=1),
                      w // grid, axis=2)
    return mask[..., None]


def prefetch_to_device(iterator, sharding=None, buffer_size: int = 2,
                       multihost: bool | None = None):
    """Async host->device feed: decode/stack on a worker thread, device_put
    ahead of consumption so the accelerator never idles on input.

    ``sharding`` is a NamedSharding (e.g. parallel.data_sharding(mesh)) for
    multi-chip batch sharding; None = default placement. ``multihost``
    (default: ``jax.process_count() > 1``) treats each item as this
    process's slice of the global batch and assembles the global sharded
    array via ``jax.make_array_from_process_local_data`` — pair it with
    ``ImageFolderDataset.batches(process_index=..., process_count=...)``
    so each host only decodes its own shard (DCN never carries pixels;
    only each host's slice rides its local PCIe).
    """
    if multihost is None:
        multihost = jax.process_count() > 1
    if multihost and sharding is None:
        raise ValueError("multihost prefetch needs an explicit sharding")

    def _put(x):
        if sharding is None:
            return jax.device_put(x)
        if multihost:
            return jax.make_array_from_process_local_data(sharding, x)
        return jax.device_put(x, sharding)

    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(jax.tree.map(_put, item))
            q.put(_END)
        except BaseException as e:  # propagate to the consumer, don't swallow
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
