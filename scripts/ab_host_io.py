"""A/B: host-side image I/O — PIL vs the native (libjpeg-turbo) loader.

The end-to-end folder pipeline can be bound by host JPEG decode and encode.
This harness measures, on one generated folder of realistic JPEGs:

  decode : bytes-on-disk -> 256^2 canvas uint8 batch
  save   : 256^2 canvas uint8 -> aspect-crop -> resize-back -> encode -> disk
  both   : the full host round trip (what bounds the real pipeline)

Interleaved rounds, min-of-N, same-script.

Usage: python scripts/ab_host_io.py [--n 256] [--src 512] [--rounds 4]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multi_style_transfer_gan.native import (  # noqa: E402
    available, decode_canvas_batch, save_canvas_batch,
)
from multi_style_transfer_gan.pipelines.batch import (  # noqa: E402
    _decode_canvas, _restore_and_save,
)


def make_folder(root, n, src, seed=0):
    """Realistic photo-like JPEGs: smooth gradients + texture, mixed aspect."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        w = src if i % 3 else int(src * 4 / 3)
        h = src if i % 3 != 1 else int(src * 3 / 4)
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([
            120 + 80 * np.sin(xx / w * 3 + i), 100 + 60 * (yy / h),
            140 + 50 * np.cos((xx + yy) / (w + h) * 5)], -1)
        img = np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255
                      ).astype(np.uint8)
        p = os.path.join(root, f"img_{i:04d}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--src", type=int, default=512)
    ap.add_argument("--canvas", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    assert available(), "native library unavailable"

    with tempfile.TemporaryDirectory() as td:
        paths = make_folder(td, args.n, args.src)
        out_dir = os.path.join(td, "out")
        os.makedirs(out_dir)
        styled = np.random.default_rng(1).integers(
            0, 256, (args.n, args.canvas, args.canvas, 3), np.uint8)

        def pil_decode():
            arrs, sizes = [], []
            for p in paths:
                a, wh = _decode_canvas(p, args.canvas)
                arrs.append(a)
                sizes.append(wh)
            return np.stack(arrs), sizes

        def nat_decode():
            arr, sizes, ok = decode_canvas_batch(paths, args.canvas, 255,
                                                 num_threads=2)
            assert ok.all()
            return arr, sizes

        _, sizes_ref = pil_decode()
        _, sizes_nat = nat_decode()
        assert sizes_ref == sizes_nat, "size metadata mismatch"

        def pil_save():
            for j, p in enumerate(paths):
                _restore_and_save(styled[j], sizes_ref[j],
                                  os.path.join(out_dir, os.path.basename(p)),
                                  args.canvas)

        def nat_save():
            ok = save_canvas_batch(styled, sizes_ref,
                                   [os.path.join(out_dir, os.path.basename(p))
                                    for p in paths], num_threads=2)
            assert ok.all()

        results = {}
        for name, fn in [("pil_decode", pil_decode), ("nat_decode", nat_decode),
                         ("pil_save", pil_save), ("nat_save", nat_save)]:
            fn()  # warm page cache / JIT imports
            results[name] = float("inf")
        for _ in range(args.rounds):
            for name, fn in [("pil_decode", pil_decode),
                             ("nat_decode", nat_decode),
                             ("pil_save", pil_save), ("nat_save", nat_save)]:
                t0 = time.perf_counter()
                fn()
                results[name] = min(results[name], time.perf_counter() - t0)

        n = args.n
        print(f"\nfolder: {n} JPEGs ~{args.src}px -> canvas {args.canvas}")
        for name in ["pil_decode", "nat_decode", "pil_save", "nat_save"]:
            t = results[name]
            print(f"  {name:11s}: {t:7.3f}s  = {n / t:8.1f} img/s")
        print(f"  decode speedup: {results['pil_decode'] / results['nat_decode']:.2f}x")
        print(f"  save   speedup: {results['pil_save'] / results['nat_save']:.2f}x")
        rt_pil = results["pil_decode"] + results["pil_save"]
        rt_nat = results["nat_decode"] + results["nat_save"]
        print(f"  host round trip: PIL {n / rt_pil:.1f} img/s, "
              f"native {n / rt_nat:.1f} img/s ({rt_pil / rt_nat:.2f}x)")


if __name__ == "__main__":
    main()
