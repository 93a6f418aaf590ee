"""Throughput benchmark of the folder program on one GPU.

Runs the flagship EnhancedGenerator (deployed config: channels=16, one
transformer block — enhanced_train.py:18) with random weights through the
program users run (``pipelines.batch.make_batch_fn``, cyclegan mode, bf16,
uint8 in and out) and prints ONE JSON line:

- ``value``: device-program images/s at 512^2 x 128, distinct input batches
  dispatched back to back, median over rounds;
- ``end_to_end``: the REAL folder pipeline — JPEG bytes on disk -> decode ->
  stylize -> aspect-restore -> encoded output on disk (``batch_process``)
  at the 256 canvas (batch 64) and the 512 canvas (batch 32), each beside
  the device-program rate of the same shape;
- ``device``: platform, device_kind and count as JAX reports them.

It fails when JAX finds no GPU. It prints no roofline share: that needs a
peak table keyed by device_kind, which the benchmark does not carry yet.
One process drives the card.
"""

import json
import os
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

SIZE = 512
BATCH = 128
ITERS = 6
ROUNDS = 5
END_TO_END_N = 256        # folder size for the end-to-end run
END_TO_END_SRC = 512      # source JPEG long side (realistic photo inputs)


def _model():
    from multi_style_transfer_gan.models import (
        enhanced_generator_apply, enhanced_generator_init,
    )
    from multi_style_transfer_gan.pipelines.model_loader import LoadedModel

    params = enhanced_generator_init(jax.random.PRNGKey(0), channels=16,
                                     num_transformer_blocks=1)
    return LoadedModel(kind="enhanced", channels=16, direction="AB",
                       params=params,
                       apply=lambda x: enhanced_generator_apply(params, x))


def device_rate(model, canvas, batch, iters=ITERS, rounds=ROUNDS):
    """Images/s of the bf16 cyclegan program on pre-staged batches."""
    from multi_style_transfer_gan.pipelines.batch import make_batch_fn

    run_fn = make_batch_fn(model, "cyclegan", "enhanced", 0.8, 0.7, True,
                           True, compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    batches = [jax.device_put(rng.integers(0, 256, (batch, canvas, canvas, 3),
                                           dtype=np.uint8))
               for _ in range(iters)]
    jax.block_until_ready([run_fn(b) for b in batches])  # compile + warm
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready([run_fn(b) for b in batches])
        times.append(time.perf_counter() - t0)
    return batch * iters / float(np.median(times))


def end_to_end(model, canvas):
    """The folder pipeline on generated JPEGs; the first run pays the
    compile, the second is the measurement."""
    from scripts.ab_host_io import make_folder
    from multi_style_transfer_gan.pipelines.batch import batch_process

    batch_size = 64 if canvas == 256 else 32
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in")
        os.makedirs(src)
        make_folder(src, END_TO_END_N, END_TO_END_SRC)
        kwargs = dict(mode="cyclegan", batch_size=batch_size,
                      compute_dtype=jnp.bfloat16, canvas=canvas)
        batch_process(model, src, os.path.join(td, "warm"), **kwargs)
        stats = batch_process(model, src, os.path.join(td, "out"), **kwargs)
    device_only = device_rate(model, canvas, batch_size)
    return {
        "img_s": round(stats["imgs_per_sec"], 1),
        "device_only_img_s": round(device_only, 1),
        "n_images": stats["processed"],
        "canvas": canvas,
        "host_cores": os.cpu_count(),
    }


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs an NVIDIA GPU; JAX found "
                         f"{dev.platform!r}")
    from multi_style_transfer_gan.utils import enable_compilation_cache

    enable_compilation_cache()
    model = _model()
    value = device_rate(model, SIZE, BATCH)
    e2e = {f"canvas{c}": end_to_end(model, c) for c in (256, 512)}
    print(json.dumps({
        "metric": "512x512 stylized images/sec, device program "
                  "(EnhancedGenerator c16, bf16)",
        "value": round(value, 2),
        "unit": "img/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "end_to_end": e2e,
    }))


if __name__ == "__main__":
    main()
