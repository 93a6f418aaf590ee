"""Reproduce the reference's published 54-image quality study.

The reference ships its results as Excel files in the repo root
(detailed_metrics_comparison.xlsx, comparison_results.xlsx — generated by
compare_image_quality.py:380-467 / complete_comparison.py), extracted into
BASELINE.md as the quality bar. This harness regenerates that study from
scratch — given the monet2photo dataset and the reference checkpoints — and
prints a diff against the published numbers:

  1. take up to --max_images photos from {data_root}/testB,
  2. run the plain CycleGAN generator over them (mode=cyclegan,
     photo2monet — batch_process_images.py path),
  3. run the enhanced generator with local-style 'enhanced' post-processing,
  4. run the 3-folder detailed comparison (detailed_metrics_comparison.xlsx
     + charts + win statistics, complete_comparison.py:34-429 semantics),
  5. print computed vs published averages/win-rates with deltas.

Usage:
  python scripts/reproduce_quality_study.py --data_root data/monet2photo \
      --models_dir models [--output_dir output/quality_study]

  # CI smoke (no dataset/checkpoints needed — synthetic data + random init):
  python scripts/reproduce_quality_study.py --synthetic
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published values extracted from the reference's shipped Excel files
# (BASELINE.md "Detailed 54-image study" + win-rate tables).
PUBLISHED = {
    "n_images": 54,
    "cyclegan": {"mse": 0.011143, "psnr": 19.93, "ssim": 0.5318},
    "localstyle": {"mse": 0.008828, "psnr": 21.12, "ssim": 0.7852},
    "localstyle_win_rate": {"mse": 70.4, "psnr": 70.4, "ssim": 98.1},
}


def _stage_inputs(data_root, out_dir, max_images):
    """Copy the first N testB photos into a clean originals folder."""
    src = os.path.join(data_root, "testB")
    if not os.path.isdir(src):
        raise SystemExit(f"no testB folder under {data_root}")
    names = sorted(n for n in os.listdir(src)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    if not names:
        raise SystemExit(f"no images in {src}")
    originals = os.path.join(out_dir, "originals")
    os.makedirs(originals, exist_ok=True)
    for n in names[:max_images]:
        shutil.copy2(os.path.join(src, n), os.path.join(originals, n))
    return originals


def run_study(originals, cyclegan_model, enhanced_model, output_dir,
              batch_size=16, canvas=256):
    from multi_style_transfer_gan.pipelines.batch import batch_process
    from multi_style_transfer_gan.metrics.evaluation import (
        complete_comparison,
    )

    work = os.path.join(output_dir, "outputs")
    batch_process(cyclegan_model, originals, work, mode="cyclegan",
                  direction="photo2monet", batch_size=batch_size,
                  canvas=canvas)
    batch_process(enhanced_model, originals, work, mode="local_style",
                  local_style_mode="enhanced", direction="photo2monet",
                  batch_size=batch_size, canvas=canvas)
    return complete_comparison(
        originals,
        os.path.join(work, "cyclegan_photo2monet"),
        os.path.join(work, "local_style_enhanced_photo2monet"),
        name_a="cyclegan", name_b="localstyle", output_dir=output_dir)


def print_diff(results):
    n = results["n_images"]
    print(f"\n=== computed vs published (n={n} vs "
          f"{PUBLISHED['n_images']} images) ===")
    rows = []
    for model in ("cyclegan", "localstyle"):
        got = results.get(model) or {}
        for metric in ("mse", "psnr", "ssim"):
            pub = PUBLISHED[model][metric]
            val = got.get(metric)
            d = None if val is None else val - pub
            rows.append((f"{model} avg {metric}", pub, val, d))
    wins = results["wins"]["localstyle"]
    for metric in ("mse", "psnr", "ssim"):
        pub = PUBLISHED["localstyle_win_rate"][metric]
        val = 100.0 * wins[metric] / max(n, 1)
        rows.append((f"localstyle win% {metric}", pub, val, val - pub))
    print(f"{'quantity':28s} {'published':>10s} {'computed':>10s} "
          f"{'delta':>9s}")
    for name, pub, val, d in rows:
        vs = "   n/a" if val is None else f"{val:10.4f}"
        ds = "" if d is None else f"{d:+9.4f}"
        print(f"{name:28s} {pub:10.4f} {vs} {ds}")
    print(f"verdict: {results['verdict']}")
    print(f"tables:  {results['xlsx']}")


def synthetic_smoke(output_dir=None, canvas=64, n_images=6, seed=0):
    """CI-testable end-to-end run: tiny synthetic photos + random-init
    generators exercise the full stage→forward→post→compare→xlsx machinery
    without the dataset or checkpoints."""
    import numpy as np
    from PIL import Image

    import jax

    from multi_style_transfer_gan.models import (
        plain_generator_init, plain_generator_apply,
        enhanced_generator_init, enhanced_generator_apply,
    )
    from multi_style_transfer_gan.pipelines.model_loader import LoadedModel

    td = output_dir or tempfile.mkdtemp(prefix="quality_study_")
    root = os.path.join(td, "monet2photo", "testB")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        g = np.linspace(40, 215, canvas)
        img = np.stack([np.add.outer(g, g[::-1]) / 2.0 + 20 * c
                        for c in range(3)], -1)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255
                      ).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"photo_{i}.jpg"),
                                  quality=92)

    pp = plain_generator_init(jax.random.PRNGKey(0), channels=8)
    plain = LoadedModel(kind="plain", channels=8, direction="BA", params=pp,
                        apply=lambda x: plain_generator_apply(pp, x))
    ep = enhanced_generator_init(jax.random.PRNGKey(1), channels=4,
                                 num_transformer_blocks=1)
    enh = LoadedModel(
        kind="enhanced", channels=4, direction="BA", params=ep,
        apply=lambda x: enhanced_generator_apply(ep, x))

    out_dir = os.path.join(td, "study")
    originals = _stage_inputs(os.path.join(td, "monet2photo"), out_dir,
                              n_images)
    results = run_study(originals, plain, enh, out_dir, batch_size=4,
                        canvas=canvas)
    print_diff(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", type=str, default="data/monet2photo")
    ap.add_argument("--models_dir", type=str, default="models")
    ap.add_argument("--output_dir", type=str, default="output/quality_study")
    ap.add_argument("--max_images", type=int, default=54)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--synthetic", action="store_true",
                    help="smoke mode: synthetic data + random-init models")
    args = ap.parse_args(argv)

    if args.synthetic:
        synthetic_smoke()
        return 0

    from multi_style_transfer_gan.utils import enable_compilation_cache

    enable_compilation_cache()
    from multi_style_transfer_gan.pipelines import load_generator

    cyc_path = os.path.join(args.models_dir, "cyclegan_epoch_200.pth")
    enh_path = os.path.join(args.models_dir, "G_BA_epoch_200.pth")
    for p in (cyc_path, enh_path):
        if not os.path.exists(p):
            raise SystemExit(f"missing checkpoint: {p} (reference layout — "
                             "batch_process_images.py:66,91,107)")
    plain = load_generator(cyc_path, prefer="G_BA_state_dict")
    enh = load_generator(enh_path)

    os.makedirs(args.output_dir, exist_ok=True)
    originals = _stage_inputs(args.data_root, args.output_dir,
                              args.max_images)
    results = run_study(originals, plain, enh, args.output_dir,
                        batch_size=args.batch_size)
    print_diff(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
