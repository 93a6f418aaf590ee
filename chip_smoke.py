#!/usr/bin/env python3
"""Smoke run of the system's main path on NVIDIA GPUs.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the multi-device paths only

One card, one process, through the entry points a user calls, at the full
width of the deployed EnhancedGenerator (16 trunk channels, one
transformer block) with random weights from ``--seed``:

1. device: refuses anything but a GPU; prints the card, versions, flags
   and the compile-cache directory;
2. inference: the ``make_batch_fn`` program (the one ``batch_process`` and
   the server run) in bf16 at canvas 256 x 64 and 512 x 32, in modes
   cyclegan and local_style/enhanced; then ``StyleTransferService`` +
   ``MicroBatcher`` answering 8 concurrent requests; then ``batch_process``
   on a generated folder of JPEGs;
3. training: the train CLI's own step (``make_train_step``) at the
   reference recipe — batch 8, 256^2, bf16, pool 50, lr decay — for 20
   steps on synthetic data;
4. parity on the card, every reference at ``precision="highest"``: the
   LocalAttention kernel against ``_attention_math`` at the stage shapes of
   both canvases, the bf16 program against the float32 forward, the
   trained checkpoint against its golden, the first training step against
   the CPU backend, SSIM against the CPU;
5. ``compiled.memory_analysis()`` of the inference and training programs.

``--multi`` runs only what needs several cards, each against one card: the
CycleGAN step on (4, 1) and (2, 2) (data, model) meshes, the batch
program over a 4-way data mesh, and ``spatial_apply`` with sp=4 on a
2048^2 image.

Any failed check raises, so the exit code is non-zero and no result line is
printed. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CANVASES = ((256, 64), (512, 32))  # (canvas, batch) of the folder program
TRAINED = os.path.join(HERE, "trained", "G_BA_selected.pth")
GOLDEN = os.path.join(HERE, "trained", "golden_gba_128.npy")


def log(*a):
    print(*a, flush=True)


def require_gpu():
    """The first JAX device must be a GPU; otherwise exit non-zero before
    anything runs."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{dev.platform!r}; nothing was run", file=sys.stderr)
        sys.exit(2)
    return dev


def describe_device(n_required: int):
    import jax
    import jaxlib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    for line in smi.strip().splitlines():
        log(line.strip())
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS')}")
    devices = jax.devices()
    log(f"devices: {len(devices)} x {devices[0].device_kind}")
    if len(devices) < n_required:
        raise SystemExit(f"need {n_required} GPUs, found {len(devices)}")


def timed(fn, *args, n=10):
    """Median wall time of ``fn(*args)`` in ms, each call ended by
    block_until_ready (after one warm call)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def photos(n, size, seed):
    """n uint8 photo-like images (the synthetic renderer, numpy only)."""
    from multi_style_transfer_gan.data.synthetic import render_photo

    uniq = [render_photo(seed + i, size=size) for i in range(min(n, 8))]
    return np.stack([uniq[i % len(uniq)] for i in range(n)])


def random_model(seed):
    import jax

    from multi_style_transfer_gan.models import (
        enhanced_generator_apply, enhanced_generator_init,
    )
    from multi_style_transfer_gan.pipelines.model_loader import LoadedModel

    params = enhanced_generator_init(jax.random.PRNGKey(seed), channels=16,
                                     num_transformer_blocks=1)
    return LoadedModel(kind="enhanced", channels=16, direction=None,
                       params=params,
                       apply=lambda x: enhanced_generator_apply(params, x))


def memory(name, compiled):
    m = compiled.memory_analysis()
    log(f"memory_analysis {name}: argument {m.argument_size_in_bytes} "
        f"output {m.output_size_in_bytes} temp {m.temp_size_in_bytes} "
        f"generated_code {m.generated_code_size_in_bytes} bytes")


# ---------------------------------------------------------------------------
# 2. inference
# ---------------------------------------------------------------------------

def phase_inference(model, seed):
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.pipelines.batch import make_batch_fn

    for canvas, batch in CANVASES:
        x = jax.device_put(photos(batch, canvas, seed))
        for mode in ("cyclegan", "local_style"):
            run_fn = make_batch_fn(model, mode, "enhanced", 0.8, 0.7, True,
                                   True, compute_dtype=jnp.bfloat16)
            jitted, params = run_fn.func, run_fn.args[0]
            t0 = time.perf_counter()
            compiled = jitted.lower(params, x).compile()
            t_compile = time.perf_counter() - t0
            out = np.asarray(compiled(params, x))
            assert out.shape == x.shape and out.dtype == np.uint8, out.shape
            assert out.std() > 1.0, f"{mode} output is constant"
            ms = timed(compiled, params, x)
            log(f"inference {mode} canvas {canvas} batch {batch} bf16: "
                f"compile {t_compile:.1f} s, {ms:.3f} ms/batch "
                f"({batch / ms * 1e3:.1f} img/s, device program only)")
            memory(f"inference_{mode}_{canvas}x{batch}", compiled)


def phase_server(model, seed, canvas=256):
    import jax.numpy as jnp
    from PIL import Image

    from multi_style_transfer_gan.data.synthetic import render_photo
    from multi_style_transfer_gan.serving import StyleTransferService

    svc = StyleTransferService(model, canvas=canvas, max_batch=8,
                               compute_dtype=jnp.bfloat16)
    try:
        svc.warmup()
        requests, sizes = [], []
        for i in range(8):
            img = render_photo(seed + 100 + i, size=320)[:, : 200 + 15 * i]
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            requests.append(buf.getvalue())
            sizes.append((img.shape[1], img.shape[0]))
        with ThreadPoolExecutor(max_workers=8) as ex:
            answers = list(ex.map(svc.stylize_bytes, requests))
        for data, size in zip(answers, sizes):
            out = Image.open(io.BytesIO(data))
            assert out.size == size, (out.size, size)
        stats = svc.stats()
        assert stats["requests"] >= 8, stats
        log(f"server: 8 concurrent requests answered; stats {stats}")
    finally:
        svc.close()


def phase_folder(model, seed, n=96, canvas=256):
    import jax.numpy as jnp
    from PIL import Image

    from multi_style_transfer_gan.pipelines import batch_process

    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in")
        os.makedirs(src)
        imgs = photos(8, 384, seed + 200)
        sizes = {}
        for i in range(n):
            img = imgs[i % 8][: 384 - 32 * (i % 3), : 384 - 48 * (i % 4)]
            name = f"img_{i:03d}.jpg"
            Image.fromarray(img).save(os.path.join(src, name), quality=90)
            sizes[name] = (img.shape[1], img.shape[0])
        stats = None
        for run in ("warm", "out"):
            stats = batch_process(model, src, os.path.join(td, run),
                                  mode="cyclegan", batch_size=64,
                                  compute_dtype=jnp.bfloat16, canvas=canvas)
        assert stats["processed"] == n, stats
        for name, size in sizes.items():
            with Image.open(os.path.join(stats["out_dir"], name)) as im:
                assert im.size == size, (name, im.size, size)
        log(f"batch_process: {n} JPEGs, second run "
            f"{stats['imgs_per_sec']:.1f} img/s end to end (host decode "
            f"and encode included)")


# ---------------------------------------------------------------------------
# 3. training
# ---------------------------------------------------------------------------

def domain_batches(n_batches, batch, size, seed):
    from multi_style_transfer_gan.data.synthetic import monetize

    a = photos(batch * n_batches, size, seed)
    b = np.stack([monetize(photos(1, size, seed + 1000 + i)[0],
                           stroke_seed=i) for i in range(batch * n_batches)])
    return (a.reshape(n_batches, batch, size, size, 3),
            b.reshape(n_batches, batch, size, size, 3))


def phase_training(seed, steps=20, batch=8, size=256, pool_size=50):
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.train import cyclegan_init_state, pool_init
    from multi_style_transfer_gan.train.cyclegan import (
        make_optimizers, make_train_step,
    )

    # --lr_decay over a 40-step run: constant to step 20, then linear
    g_tx, d_tx = make_optimizers(decay_steps=2 * steps)
    state = cyclegan_init_state(jax.random.PRNGKey(seed), 16, 1,
                                txs=(g_tx, d_tx))
    pools = ((pool_init(pool_size, size, jnp.bfloat16),
              pool_init(pool_size, size, jnp.bfloat16)),
             jax.random.PRNGKey(seed + 1))
    step = make_train_step(g_tx, d_tx, compute_dtype=jnp.bfloat16,
                           pools=True)
    a, b = domain_batches(4, batch, size, seed + 300)
    a, b = jax.device_put(a), jax.device_put(b)
    # The first step compiles twice: the spectral-norm ``v`` buffers start
    # as None and are arrays from the second step on.
    times, losses = [], None
    for i in range(steps):
        t0 = time.perf_counter()
        state, losses, pools = step(state, pools, a[i % 4], b[i % 4])
        losses = {k: float(v) for k, v in losses.items()}
        times.append(time.perf_counter() - t0)
        bad = {k: v for k, v in losses.items() if not np.isfinite(v)}
        assert not bad, f"step {i + 1}: non-finite losses {bad}"
        if i in (0, steps - 1):
            log(f"train step {i + 1}: " + " ".join(
                f"{k}={v:.4f}" for k, v in losses.items()))
        if i == 1:
            log(f"train steps 1-2 (both compiles included): "
                f"{times[0] + times[1]:.1f} s")
            memory(f"train_step_b{batch}_{size}_bf16",
                   step.lower(state, pools, a[0], b[0]).compile())
    assert int(pools[0][0].n) == pool_size, "pool did not fill"
    log(f"training: {steps} steps, finite losses, "
        f"{np.median(times[2:]) * 1e3:.1f} ms/step median after 2 "
        f"(host loop wall time, losses fetched each step)")


# ---------------------------------------------------------------------------
# 4. parity
# ---------------------------------------------------------------------------

def stage_shapes():
    """LocalAttention inputs of the folder program at both canvases:
    down1, down2, up1 (= down1's shape) and up2."""
    shapes = []
    for canvas, batch in CANVASES:
        for scale, c in ((2, 32), (4, 64), (1, 16)):
            shapes.append((batch, canvas // scale, canvas // scale, c))
    return shapes


def phase_kernel_parity(seed):
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.models.enhanced_generator import (
        _attention_math,
    )
    from multi_style_transfer_gan.ops.pallas.window_attention import (
        window_channel_attention,
    )

    rng = np.random.default_rng(seed)
    xla = jax.jit(lambda *a: _attention_math(*a, window_size=4, eps=1e-12))
    for shape in stage_shapes():
        C = shape[-1]
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        w = (jnp.asarray(rng.standard_normal((1, 1, C, 3 * C)) * 0.3,
                         jnp.float32),
             jnp.asarray(rng.standard_normal((3 * C,)) * 0.1, jnp.float32),
             jnp.asarray(rng.standard_normal((1, 1, C, C)) * 0.3,
                         jnp.float32),
             jnp.asarray(rng.standard_normal((C,)) * 0.1, jnp.float32))
        xb = x.astype(jnp.bfloat16)
        with jax.default_matmul_precision("highest"):
            ref = xla(x, *w)
            err_f32 = float(jnp.max(jnp.abs(
                window_channel_attention(x, *w) - ref)))
            ref_b = xla(xb.astype(jnp.float32), *w)
        scale = max(1.0, float(jnp.max(jnp.abs(ref_b))))
        err_b = float(jnp.max(jnp.abs(
            window_channel_attention(xb, *w).astype(jnp.float32) - ref_b)))
        err_xla_b = float(jnp.max(jnp.abs(
            xla(xb, *w).astype(jnp.float32) - ref_b)))
        assert err_f32 <= 1e-4, (shape, err_f32)
        # bf16 outputs of magnitude ~8 carry a rounding error of up to
        # 2^-5 on their own, so the absolute bound scales with max|ref|;
        # the tight check is against XLA's own bf16 error on the same input
        assert err_b <= 2e-2 * scale, (shape, err_b, scale)
        assert err_b <= 1.1 * err_xla_b + 1e-3, (shape, err_b, err_xla_b)
        ms = {}
        for name, fn, arg in (("kernel_bf16", window_channel_attention, xb),
                              ("xla_bf16", xla, xb),
                              ("kernel_f32", window_channel_attention, x),
                              ("xla_f32", xla, x)):
            ms[name] = timed(fn, arg, *w, n=20)
        log(f"attention {shape}: f32 max|err| {err_f32:.2e} (<= 1e-4); "
            f"bf16 max|err| {err_b:.3e} (XLA's own bf16 {err_xla_b:.3e}; "
            f"bounds 2e-2 x {scale:.2f} and 1.1 x XLA's + 1e-3); ms " + " ".join(
                f"{k}={v:.4f}" for k, v in ms.items()))


def phase_generator_timing(model, seed):
    """The whole generator forward with the kernel against the same forward
    in plain XLA, at both folder-program shapes (bf16), in turns."""
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.models import enhanced_generator_apply

    fwd = {name: jax.jit(lambda p, x, f=fast: enhanced_generator_apply(
               p, x, fast_attention=f))
           for name, fast in (("kernel", True), ("xla", False))}
    for canvas, batch in CANVASES:
        x = jax.device_put(photos(batch, canvas, seed).astype(np.float32)
                           / 127.5 - 1.0).astype(jnp.bfloat16)
        ms = {"kernel": [], "xla": []}
        for order in (("xla", "kernel"), ("kernel", "xla")) * 2:
            for name in order:
                ms[name].append(timed(fwd[name], model.params, x, n=5))
        log(f"generator canvas {canvas} batch {batch} bf16 ms/batch: "
            f"kernel {ms['kernel']} xla {ms['xla']}")


def to_u8(y):
    import jax.numpy as jnp

    return np.asarray(jnp.clip(jnp.round((y.astype(jnp.float32) + 1.0)
                                         * 127.5), 0, 255), np.uint8)


def phase_program_parity(seed):
    """The bf16 folder program (cyclegan mode, kernel) against the float32
    XLA forward at precision highest, in uint8 units, next to the error of
    the same bf16 program with plain XLA attention."""
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.models import enhanced_generator_apply
    from multi_style_transfer_gan.ops import to_model_range
    from multi_style_transfer_gan.pipelines import load_generator
    from multi_style_transfer_gan.pipelines.batch import make_batch_fn

    x_u8 = jax.device_put(photos(4, 256, seed + 400))
    for label, model in (("random", random_model(seed)),
                         ("trained", load_generator(TRAINED))):
        run_fn = make_batch_fn(model, "cyclegan", "enhanced", 0.8, 0.7,
                               True, True, compute_dtype=jnp.bfloat16)
        got = np.asarray(run_fn(x_u8)).astype(np.int32)
        xin = to_model_range(x_u8)
        with jax.default_matmul_precision("highest"):
            ref = to_u8(jax.jit(enhanced_generator_apply)(model.params, xin))
        xla_b = to_u8(jax.jit(enhanced_generator_apply)(
            model.params, xin.astype(jnp.bfloat16)))
        d = np.abs(got - ref)
        dx = np.abs(xla_b.astype(np.int32) - ref)
        log(f"program parity ({label} weights, 256^2 x 4): bf16 program vs "
            f"f32 highest: max {d.max()} mean {d.mean():.4f} p99 "
            f"{np.percentile(d, 99):.1f} uint8 levels; XLA bf16 forward: "
            f"max {dx.max()} mean {dx.mean():.4f} p99 "
            f"{np.percentile(dx, 99):.1f}")
        # the kernel rounds to bf16 at other points than XLA does, so single
        # pixels move; a fault would move the mean and the tail with them
        p99, dx_p99 = np.percentile(d, 99), np.percentile(dx, 99)
        assert d.mean() <= 1.25 * dx.mean() + 0.25, (d.mean(), dx.mean())
        assert p99 <= 1.1 * dx_p99 + 1, (p99, dx_p99)
        assert d.max() <= 2 * dx.max(), (d.max(), dx.max())


def phase_trained_golden():
    import jax.numpy as jnp

    from multi_style_transfer_gan.data.synthetic import render_photo
    from multi_style_transfer_gan.ops import from_model_range, to_model_range
    from multi_style_transfer_gan.pipelines import load_generator

    m = load_generator(TRAINED, precision="highest")
    img = render_photo(900100, size=128)
    x = to_model_range(jnp.asarray(img, jnp.float32) / 255.0)[None]
    y = np.asarray(from_model_range(m.apply(x))[0], np.float32)
    err = float(np.abs(y - np.load(GOLDEN).astype(np.float32)).max())
    log(f"trained G_BA vs golden (128^2, highest): max|err| {err:.2e} "
        f"(<= 5e-3)")
    assert err <= 5e-3, err


def phase_training_parity(seed):
    """First float32 training step at precision highest: GPU against the
    CPU backend of this process, losses to 1e-4 relative."""
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.train import cyclegan_init_state, pool_init
    from multi_style_transfer_gan.train.cyclegan import (
        make_optimizers, make_train_step,
    )

    g_tx, d_tx = make_optimizers(decay_steps=4)
    state = cyclegan_init_state(jax.random.PRNGKey(seed), 16, 1,
                                txs=(g_tx, d_tx))
    pools = ((pool_init(8, 128), pool_init(8, 128)),
             jax.random.PRNGKey(seed + 1))
    a, b = domain_batches(1, 2, 128, seed + 500)
    step = make_train_step(g_tx, d_tx, compute_dtype=jnp.float32,
                           pools=True)
    losses = {}
    for name in ("gpu", "cpu"):
        # a copy on each device: the step donates its state
        args = jax.device_put((state, pools, a[0], b[0]),
                              jax.devices(name)[0], may_alias=False)
        with jax.default_matmul_precision("highest"):
            _, out, _ = step(*args)
        losses[name] = {k: float(v) for k, v in out.items()}
    rel = {k: abs(losses["gpu"][k] - v) / max(abs(v), 1e-8)
           for k, v in losses["cpu"].items()}
    log(f"training step GPU vs CPU (f32 highest, 2 x 128^2): max rel "
        f"{max(rel.values()):.2e} (<= 1e-4); gpu {losses['gpu']}")
    assert max(rel.values()) <= 1e-4, rel


def phase_ssim_parity(seed):
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.metrics.quality import ssim

    a = photos(2, 128, seed + 600).astype(np.float32) / 255.0
    b = np.clip(a + np.random.default_rng(seed).normal(0, 0.05, a.shape),
                0, 1).astype(np.float32)
    got = {}
    for name in ("gpu", "cpu"):
        dev = jax.devices(name)[0]
        with jax.default_matmul_precision("highest"):
            got[name] = np.asarray(ssim(
                jax.device_put(jnp.asarray(a), dev),
                jax.device_put(jnp.asarray(b), dev)))
    d = float(np.abs(got["gpu"] - got["cpu"]).max())
    log(f"ssim GPU vs CPU: {got['gpu']} vs {got['cpu']}, max|d| {d:.2e} "
        f"(<= 1e-4)")
    assert d <= 1e-4, d


# ---------------------------------------------------------------------------
# --multi: four cards
# ---------------------------------------------------------------------------

# The pooled fakes are generator outputs in [-1, 1]. cuDNN picks its
# convolution algorithms per shape (2 images per card against 8 on one), so
# float32 sums reassociate and the random-init generator's InstanceNorms
# amplify that: 1.17e-4 at (4, 1) on four H100s, where virtual CPU devices
# stay under 1e-4. A pool that took a wrong slot or image differs by O(1),
# so 1e-3 still proves the pool law with room to spare.
POOL_ATOL_GPU = 1e-3


def multi_train_step(seeds=(0, 1)):
    import jax

    import __graft_entry__ as graft

    pool = {}
    for shape in ((4, 1), (2, 2)):
        for seed in seeds:
            with jax.default_matmul_precision("highest"):
                rel, pool[shape, seed] = graft.dryrun_multichip(4, shape,
                                                                seed)
            log(f"multi: CycleGAN step on (data, model) = {shape}, seed "
                f"{seed}, vs one card, f32 highest: max rel loss delta "
                f"{rel:.3e} (<= 5e-5), pool fill and key equal, pooled "
                f"fakes max|d| {pool[shape, seed]:.3e}")
    worst = max(pool.values())
    log(f"multi: pooled fakes max|d| over meshes and seeds {worst:.3e} "
        f"(<= {POOL_ATOL_GPU:g})")
    assert worst <= POOL_ATOL_GPU, pool


def multi_batch_program(seed, batch=64, canvas=256):
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.parallel import data_sharding, make_mesh
    from multi_style_transfer_gan.pipelines.batch import make_batch_fn

    model = random_model(seed)
    mesh = make_mesh(jax.devices()[:4])
    x = photos(batch, canvas, seed + 700)
    for dtype, bound in ((None, 1), (jnp.bfloat16, None)):
        one = make_batch_fn(model, "cyclegan", "enhanced", 0.8, 0.7, True,
                            True, compute_dtype=dtype)
        four = make_batch_fn(model, "cyclegan", "enhanced", 0.8, 0.7, True,
                             True, compute_dtype=dtype, mesh=mesh)
        x1 = jax.device_put(x, jax.devices()[0])
        x4 = jax.device_put(x, data_sharding(mesh, 4))
        with jax.default_matmul_precision("highest" if dtype is None
                                          else "default"):
            d = np.abs(np.asarray(four(x4)).astype(np.int32)
                       - np.asarray(one(x1)).astype(np.int32))
            ms1, ms4 = timed(one, x1, n=5), timed(four, x4, n=5)
        name = "f32 highest" if dtype is None else "bf16"
        log(f"multi: batch program {batch} x {canvas}^2 {name}, 4-way data "
            f"mesh vs "
            f"one card: max |d| {d.max()} uint8 levels; {ms4:.2f} vs "
            f"{ms1:.2f} ms/batch")
        if bound is not None:
            assert d.max() <= bound, d.max()


def multi_spatial(seed, size=2048):
    """sp=4 against one card with the trained weights: spatial users run
    a trained model, and a random-init generator amplifies rounding about
    20-fold (bf16 against float32 in phase_program_parity: 8.3 uint8
    levels on average with random weights, 0.38 with trained ones)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multi_style_transfer_gan.models import enhanced_generator_apply
    from multi_style_transfer_gan.parallel import spatial_apply, spatial_mesh
    from multi_style_transfer_gan.pipelines import load_generator
    from multi_style_transfer_gan.sharding_spec import ShardedFastAttention

    model = load_generator(TRAINED)
    x = jnp.asarray(photos(1, size, seed + 800).astype(np.float32)
                    / 127.5 - 1.0)
    mesh = spatial_mesh(4)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(spatial_apply(model, mesh=mesh)(x))
        ref = np.asarray(jax.jit(enhanced_generator_apply)(
            model.params, jax.device_put(x, jax.devices()[0])))
    err = float(np.abs(got - ref).max())
    log(f"multi: spatial_apply sp=4 on {size}^2 vs unsharded one card "
        f"(trained weights, f32 highest): max|err| {err:.2e} (<= 1e-3)")
    assert err <= 1e-3, err

    # bf16 timing: the per-shard kernel against plain GSPMD XLA attention
    xs = jax.device_put(x.astype(jnp.bfloat16),
                        NamedSharding(mesh, P(None, "sp")))
    fwd = {name: jax.jit(lambda p, t, f=fast: enhanced_generator_apply(
               p, t, fast_attention=f))
           for name, fast in (("kernel", ShardedFastAttention(
               mesh, P(None, "sp"))), ("xla", False))}
    ms = {name: timed(f, model.params, xs, n=5) for name, f in fwd.items()}
    log(f"multi: spatial sp=4 {size}^2 bf16 ms: {ms}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = require_gpu()
    describe_device(4 if args.multi else 1)
    sys.path.insert(0, HERE)
    from multi_style_transfer_gan.utils import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    import jax

    t_start = time.perf_counter()
    if args.multi:
        multi_train_step()
        multi_batch_program(args.seed)
        multi_spatial(args.seed)
    else:
        model = random_model(args.seed)
        phase_inference(model, args.seed)
        phase_server(model, args.seed)
        phase_folder(model, args.seed)
        phase_training(args.seed)
        phase_kernel_parity(args.seed)
        phase_generator_timing(model, args.seed)
        phase_program_parity(args.seed)
        phase_trained_golden()
        phase_training_parity(args.seed)
        phase_ssim_parity(args.seed)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
