"""Render the trained-model sample grids (input | output | ground truth).

Reproduces the trained/samples/*.jpg artifacts for a given pair of
selected checkpoints: 4 test images per direction, each row
input -> generator output -> shipped closed-form ground truth.

  PYTHONPATH=/root/repo:$PYTHONPATH python scripts/make_sample_grids.py \
      --selected_dir runs/selected --data_root data/synth_monet2photo \
      --output_dir trained/samples
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
from PIL import Image

from scripts.select_checkpoints import forward_u8, load_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--selected_dir", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--n", type=int, default=4)
    args = ap.parse_args(argv)

    from multi_style_transfer_gan.pipelines import load_generator
    from multi_style_transfer_gan.utils import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(args.output_dir, exist_ok=True)
    cases = [("BA", "testB", "truth_monet_for_testB", "photo2monet"),
             ("AB", "testA", "truth_photo_for_testA", "monet2photo")]
    for key, src, truth, label in cases:
        names = sorted(os.listdir(os.path.join(args.data_root, src)))[:args.n]
        inputs = load_batch(os.path.join(args.data_root, src), names)
        truths = load_batch(os.path.join(args.data_root, truth), names)
        model = load_generator(
            os.path.join(args.selected_dir, f"G_{key}_epoch_0.pth"),
            prefer=f"G_{key}_state_dict")
        outs = forward_u8(model.apply, inputs)
        rows = [np.concatenate([i, o, t], axis=1)
                for i, o, t in zip(inputs, outs, truths)]
        grid = np.concatenate(rows, axis=0)
        out = os.path.join(args.output_dir,
                           f"{label}_input_output_truth.jpg")
        Image.fromarray(grid).save(out, quality=92)
        print(f"saved {out} ({grid.shape[1]}x{grid.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
