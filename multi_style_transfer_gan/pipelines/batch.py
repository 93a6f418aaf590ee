"""Batch folder processing — the throughput path (batch_process_images.py).

The reference iterates images one at a time with full CPU<->device round
trips per image (batch_process_images.py:498-536 — SURVEY.md §3.2 calls this
the #1 throughput win). Here:

- a host thread pool decodes + canvas-pastes (PIL LANCZOS, exactly the
  reference recipe :186-200) into uniform uint8 batches,
- ONE jitted XLA program per mode runs normalize -> generator -> the whole
  classical-CV post chain (sky/edge masks, per-pixel weight blend, color
  boost, transition smoothing, equalize/guided-filter for 'advanced') on
  device,
- batches stream through an async prefetcher so the device never waits on
  JPEG decode, and outputs crop/save on a separate pool.

Faithful-behavior notes (verified against the reference source):
- 'advanced' computes a pyrMeanShiftFiltering segmentation it never uses
  (:373 — dead code) and its "edge sharpening" blends the image with
  itself (addWeighted(x, 1.5, x, -0.5) == x, :399-403 — a no-op); we
  replicate the *behavior* (i.e. omit both) and note it here.
- detail weight: enhanced uses strength - 0.3*detail (:337), advanced uses
  strength - 0.4*detail (:383).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..data import list_images
from ..ops import to_model_range, from_model_range, restore_aspect
from ..ops.color import rgb_to_hsv, rgb_to_gray, rgb_to_yuv, yuv_to_rgb
from ..ops.filters import (
    canny, gaussian_filter, gaussian_blur, dilate, erode,
    convert_scale_abs, equalize_hist, guided_filter,
)
from .model_loader import LoadedModel

CANVAS = 256


# ---------------------------------------------------------------------------
# host side: decode + canvas paste (exact reference PIL recipe :186-200)
# ---------------------------------------------------------------------------

def _decode_canvas(path, canvas=CANVAS, fill=255):
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w > h:
        nw, nh = canvas, int(h * (canvas / w))
    else:
        nh, nw = canvas, int(w * (canvas / h))
    resized = img.resize((nw, nh), Image.LANCZOS)
    cv = Image.new("RGB", (canvas, canvas), (fill,) * 3)
    cv.paste(resized, ((canvas - nw) // 2, (canvas - nh) // 2))
    return np.asarray(cv, np.uint8), (w, h)


def _restore_and_save(out_u8, orig_wh, out_path, canvas=CANVAS):
    """Aspect crop + resize back if <=1MP + save (:412-438)."""
    img = restore_aspect(out_u8, orig_wh, canvas)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    img.save(out_path)


# ---------------------------------------------------------------------------
# device side: one fused program per mode
# ---------------------------------------------------------------------------

def _sky_mask(canvas_f):
    """detect_sky (:126-150): V>150 & S<100; 'has sky' if fraction > 0.7."""
    hsv = rgb_to_hsv(canvas_f)
    mask = (hsv[..., 2] > 150) & (hsv[..., 1] < 100)
    frac = jnp.mean(mask.astype(jnp.float32), axis=(1, 2))
    return mask, frac > 0.7


def _detail_mask(canvas_f):
    """Canny(50,150) blurred by sigma=2, thresholded at 0.1 (:321-327)."""
    gray = rgb_to_gray(canvas_f)
    edges = canny(gray, 50.0, 150.0) > 0
    return gaussian_filter(edges.astype(jnp.float32), 2.0) > 0.1


def _smooth_transitions(img_f, mask, radius=3, iterations=2):
    """smooth_transitions (:152-174): Gaussian-blend a dilate-erode band."""
    m = mask.astype(jnp.float32)
    boundary = (dilate(m, 5, iterations) - erode(m, 5, iterations)) > 0
    blurred = gaussian_blur(img_f, radius * 2 + 1)
    return jnp.where(boundary[..., None], img_f * 0.5 + blurred * 0.5, img_f)


def _postprocess(canvas_u8f, styled_u8f, mode, strength, detail,
                 enhance_colors, smooth):
    """The mode branch of process_local_style (:304-406), batched."""
    if mode == "simple":
        out = canvas_u8f * (1 - strength) + styled_u8f * strength
        return jnp.clip(out, 0, 255)

    sky, has_sky = _sky_mask(canvas_u8f)
    detail_mask = _detail_mask(canvas_u8f)
    weight = jnp.full(canvas_u8f.shape[:-1], strength, jnp.float32)
    sky_w = min(strength + 0.2, 1.0)
    weight = jnp.where(has_sky[:, None, None] & sky, sky_w, weight)
    detail_factor = 0.3 if mode == "enhanced" else 0.4
    detail_w = max(strength - detail_factor * detail, 0.0)
    weight = jnp.where(detail_mask, detail_w, weight)
    out = canvas_u8f * (1 - weight[..., None]) + styled_u8f * weight[..., None]

    if mode == "enhanced":
        if enhance_colors:
            out = convert_scale_abs(out, alpha=1.1, beta=5)
        if smooth:
            out = _smooth_transitions(out, detail_mask, radius=3)
    else:  # advanced (:355-406)
        yuv = rgb_to_yuv(jnp.clip(out, 0, 255))
        yeq = equalize_hist(yuv[..., 0])
        out = yuv_to_rgb(jnp.stack([yeq, yuv[..., 1], yuv[..., 2]], -1))
        out = guided_filter(out, out, radius=4, eps=1e-4)
        # reference "edge sharpening" is addWeighted(x,1.5,x,-0.5)==x: no-op
    return jnp.clip(out, 0, 255)


def make_batch_fn(model: LoadedModel, mode: str, local_style_mode: str,
                  strength: float, detail: float, enhance_colors: bool,
                  smooth: bool, *, compute_dtype=None, engine: str = "nhwc",
                  mesh=None):
    """Build the single jitted uint8->uint8 program for this configuration.

    compute_dtype: generator activation dtype; jnp.bfloat16 is the fast
    path (the classical-CV post chain stays fp32 either way).
    engine: 'nhwc' (default) or 'packed' — the space-to-depth forward
    (models/packed_generator.py; enhanced models only, canvas divisible by
    32, exact same math). The NHWC enhanced forward runs LocalAttention
    through the fused kernel on the GPU (``fast_attention=True``).
    mesh: the ``data`` mesh the batch is sharded over, if any; the kernel
    then runs per batch shard.
    """

    def run(params, batch_u8):
        canvas_f = batch_u8.astype(jnp.float32)
        x = to_model_range(batch_u8)
        if compute_dtype is not None:
            x = x.astype(compute_dtype)
        y = model_forward(params, x)
        styled_f = from_model_range(y.astype(jnp.float32)) * 255.0
        if mode == "cyclegan":
            out = styled_f
        else:
            out = _postprocess(canvas_f, styled_f, local_style_mode,
                               strength, detail, enhance_colors, smooth)
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

    from ..models import plain_generator_apply, enhanced_generator_apply

    run_params = model.params
    if model.kind == "plain":
        model_forward = plain_generator_apply
    elif engine == "packed":
        from ..models.packed_generator import (
            pack_enhanced_generator_params, packed_enhanced_generator_apply,
        )

        run_params = pack_enhanced_generator_params(model.params)
        model_forward = packed_enhanced_generator_apply
    else:
        fast = True
        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..sharding_spec import ShardedFastAttention

            fast = ShardedFastAttention(mesh, P("data"))
        model_forward = partial(enhanced_generator_apply, fast_attention=fast)
    # partial OUTSIDE jit: params must stay a runtime argument — closing
    # them in would bake every weight into the program as constants and
    # blow up compile time/memory.
    return partial(jax.jit(run), run_params)


def resolve_engine(engine: str, kind: str = "enhanced") -> str:
    """The engine a run compiles. 'auto' is the NHWC engine: no
    measurement on the GPU has yet shown the packed engine ahead. The
    plain generator has a single engine."""
    if engine not in ("auto", "nhwc", "packed"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto" or kind != "enhanced":
        return "nhwc"
    return engine


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def batch_process(model: LoadedModel, input_dir, output_dir, *,
                  mode: str = "cyclegan", local_style_mode: str = "enhanced",
                  direction: str = "photo2monet", strength: float = 0.8,
                  detail: float = 0.7, enhance_colors: bool = True,
                  smooth: bool = True, batch_size: int = 64,
                  decode_workers: int = 8, compute_dtype=None, mesh=None,
                  engine: str = "auto", canvas: int = CANVAS,
                  prefetch_depth: int = 2, fetch_workers: int = 1) -> dict:
    """Process every image in ``input_dir``; returns a stats dict.

    Output layout matches the reference: ``{out}/cyclegan_{direction}/name``
    or ``{out}/local_style_{mode}_{direction}/name`` (:241, :441).

    mesh: optional ``jax.sharding.Mesh`` with a ``data`` axis — batches are
    sharded across it (params replicate; one jitted program serves any mesh
    size).
    engine: 'auto' (default) | 'nhwc' | 'packed' (see ``resolve_engine``
    and make_batch_fn). One configuration is compiled; a compile error
    surfaces.
    canvas: working resolution (the reference fixes 256 —
    batch_process_images.py:186-200; any multiple of 32 works here, e.g.
    512 for higher-fidelity output at the cost of ~4x compute).
    prefetch_depth / fetch_workers: host-overlap tuning knobs (the
    decode+H2D thread's queue bound and the D2H pool width).
    """
    if canvas % 32:
        raise ValueError(f"canvas must be a multiple of 32, got {canvas}")
    files = list_images(input_dir)
    if not files:
        print(f"error: no images found in {input_dir}")
        return {"processed": 0, "elapsed": 0.0}

    sub = (f"cyclegan_{direction}" if mode == "cyclegan"
           else f"local_style_{local_style_mode}_{direction}")
    out_dir = os.path.join(output_dir, sub)
    os.makedirs(out_dir, exist_ok=True)

    # Small folders: shrink the compiled batch to the next power of two so a
    # 3-image run doesn't pay a 64-wide padded forward (the tail batch pads
    # by repeating the last image — one compiled shape per run either way).
    pow2 = 1
    while pow2 < min(batch_size, len(files)):
        pow2 *= 2
    batch_size = min(batch_size, pow2)

    if mesh is not None:
        from ..parallel import data_sharding, local_batch_size

        # the shrunk batch must still divide over the data axis (a valid
        # user batch size shrunk for a small folder must stay valid)
        dp = mesh.shape["data"]
        batch_size = ((max(batch_size, dp) + dp - 1) // dp) * dp
        local_batch_size(batch_size, mesh)  # validates divisibility
        batch_sharding = data_sharding(mesh, 4)

    engine = resolve_engine(engine, model.kind)
    run_fn = make_batch_fn(model, mode, local_style_mode, strength, detail,
                           enhance_colors, smooth,
                           compute_dtype=compute_dtype, engine=engine,
                           mesh=mesh)

    decode_pool = ThreadPoolExecutor(max_workers=decode_workers)
    save_pool = ThreadPoolExecutor(max_workers=decode_workers)

    from ..native import (
        available as native_available, decode_canvas_batch,
        save_canvas_batch,
    )

    # The native loader (libjpeg-turbo DCT-scaled decode + float Lanczos)
    # is the default where it builds; set MSTGAN_NATIVE_DECODE=0 to force
    # the PIL path.
    use_native = (os.environ.get("MSTGAN_NATIVE_DECODE") != "0"
                  and native_available())

    n_failed = 0

    def _decode_safe(path):
        try:
            return _decode_canvas(path, canvas)
        except Exception as e:  # skip unreadable files like the reference
            print(f"error processing image {path}: {e}")
            return None

    def batches():
        nonlocal n_failed
        for i in range(0, len(files), batch_size):
            chunk = files[i:i + batch_size]
            if use_native:
                arr, sizes, ok = decode_canvas_batch(
                    chunk, canvas, 255, num_threads=decode_workers)
                if not ok.all():
                    n_failed += int((~ok).sum())
                    keep = np.where(ok)[0]
                    if keep.size == 0:
                        continue
                    chunk = [chunk[j] for j in keep]
                    sizes = [sizes[j] for j in keep]
                    arr = arr[keep]
            else:
                decoded = list(decode_pool.map(_decode_safe, chunk))
                kept = [(f, d) for f, d in zip(chunk, decoded)
                        if d is not None]
                n_failed += len(chunk) - len(kept)
                if not kept:
                    continue
                chunk = [f for f, _ in kept]
                arr = np.stack([d[0] for _, d in kept])
                sizes = [d[1] for _, d in kept]
            # pad the tail batch to the compiled batch size
            if arr.shape[0] < batch_size:
                pad = batch_size - arr.shape[0]
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)])
            yield chunk, sizes, jax.device_put(
                arr, batch_sharding if mesh is not None else None)

    t0 = time.perf_counter()
    n_done = 0
    saves = []
    # D2H + save run on their own thread so the main loop's decode + H2D
    # overlaps them.
    fetch_pool = ThreadPoolExecutor(max_workers=fetch_workers)

    # Decode + H2D also get their own thread (bounded depth): H2D of batch
    # N+1 then overlaps D2H of batch N.
    import queue as _queue
    import threading as _threading

    def _prefetched(gen, depth=prefetch_depth):
        q = _queue.Queue(maxsize=depth)
        done = object()

        def worker():
            try:
                for item in gen:
                    q.put(item)
                q.put(done)
            except BaseException as e:  # propagate into the consumer
                q.put(e)

        _threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def save_batch(host, chunk, sizes):
        """Encode one fetched batch to disk; returns the count written.
        Runs on save_pool so the fetch thread goes straight back to D2H."""
        out_paths = [os.path.join(out_dir, os.path.basename(f))
                     for f in chunk]
        done = 0
        todo = range(len(chunk))
        if use_native:
            # native batch save (aspect-crop + resize-back + turbo encode);
            # exotic extensions (BMP, ...) fall back to the PIL path below
            ok = save_canvas_batch(host[:len(chunk)], sizes, out_paths,
                                   num_threads=decode_workers)
            done += int(ok.sum())
            todo = [j for j in todo if not ok[j]]
        for j in todo:
            _restore_and_save(host[j], sizes[j], out_paths[j], canvas)
            done += 1
        return done

    def drain(entry):  # runs on fetch_pool (one worker: ordered fetches)
        chunk, sizes, dev_out = entry
        host = np.asarray(dev_out)  # D2H
        saves.append(save_pool.submit(save_batch, host, chunk, sizes))

    try:
        drains = []
        for chunk, sizes, dev_batch in _prefetched(batches()):
            dev_out = run_fn(dev_batch)  # async dispatch
            drains.append(fetch_pool.submit(drain, (chunk, sizes, dev_out)))
            if len(drains) > 2:  # bound in-flight device outputs (HBM)
                drains.pop(0).result()
        for d in drains:
            d.result()
        n_done += sum(s.result() for s in saves)
    finally:
        decode_pool.shutdown(wait=False)
        fetch_pool.shutdown(wait=True)
        save_pool.shutdown(wait=True)
    elapsed = time.perf_counter() - t0
    print(f"done: {n_done}/{len(files)} images in {elapsed:.2f}s "
          f"({n_done / max(elapsed, 1e-9):.2f} img/s, "
          f"{elapsed / max(n_done, 1):.3f}s per image)")
    return {"processed": n_done, "elapsed": elapsed,
            "imgs_per_sec": n_done / max(elapsed, 1e-9), "out_dir": out_dir}
