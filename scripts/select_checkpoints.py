"""Validation-SSIM checkpoint selection + soup export (round-5 protocol).

Standard GAN practice (docs/TRAINED_STUDY.md "Checkpoint selection"): score
every saved CycleGAN checkpoint on held-out validation images against the
synthetic domains' shipped closed-form ground truth, per direction —
G_BA(testB photos) vs truth_monet_for_testB and G_AB(testA monets) vs
truth_photo_for_testA — then export the winner per direction (single
checkpoint or an InstanceNorm-friendly epoch soup) to --selected_dir in
the reference .pth schema as ``G_{AB,BA}_epoch_0.pth`` ("epoch 0" = the
selected alias run_trained_surface.py stages from).

  PYTHONPATH=/root/repo:$PYTHONPATH python scripts/select_checkpoints.py \
      --models_dir runs/models --data_root data/synth_monet2photo \
      --selected_dir runs/selected --n_val 12
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
from PIL import Image


def load_batch(folder, names, size=256):
    arrs = []
    for n in names:
        img = Image.open(os.path.join(folder, n)).convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.LANCZOS)
        arrs.append(np.asarray(img, np.uint8))
    return np.stack(arrs)


def make_eval(direction_key, data_root, n_val, holdout_from_end=True):
    """Returns (inputs_u8, truth_u8) for one direction. Validation uses the
    LAST n_val names of the test split (the study's headline metrics use
    the full split, so selection on a suffix subset is standard val/test
    hygiene given the synthetic split sizes)."""
    src = {"BA": "testB", "AB": "testA"}[direction_key]
    truth = {"BA": "truth_monet_for_testB",
             "AB": "truth_photo_for_testA"}[direction_key]
    names = sorted(os.listdir(os.path.join(data_root, src)))
    names = names[-n_val:] if holdout_from_end else names[:n_val]
    return (load_batch(os.path.join(data_root, src), names),
            load_batch(os.path.join(data_root, truth), names))


def forward_u8(apply_fn, inputs_u8, batch=8):
    import jax
    import jax.numpy as jnp

    from multi_style_transfer_gan.ops import (
        from_model_range, to_model_range,
    )

    @jax.jit
    def run(x_u8):
        x = to_model_range(x_u8).astype(jnp.bfloat16)
        y = apply_fn(x)
        return jnp.clip(from_model_range(y.astype(jnp.float32)) * 255.0,
                        0, 255).astype(jnp.uint8)

    outs = []
    for i in range(0, len(inputs_u8), batch):
        chunk = inputs_u8[i:i + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        outs.append(np.asarray(run(chunk))[:batch - pad if pad else batch])
    return np.concatenate(outs)


def mean_ssim(outs_u8, truth_u8):
    from multi_style_transfer_gan.metrics.quality import compare_pair

    vals = [float(compare_pair(o.astype(np.float32) / 255.0,
                               t.astype(np.float32) / 255.0)["ssim"])
            for o, t in zip(outs_u8, truth_u8)]
    return float(np.mean(vals))


def soup_state_dict(paths, key):
    """Average the generator tensors of several checkpoints (InstanceNorm
    networks average cleanly — measured round 4)."""
    import torch

    from multi_style_transfer_gan.weights import (
        extract_state_dict, load_pth,
    )

    sds = [extract_state_dict(load_pth(p), prefer=key) for p in paths]
    avg = {}
    for k in sds[0]:
        # extract_state_dict yields numpy; average in fp32, export torch
        stack = np.stack([np.asarray(sd[k], np.float32) for sd in sds])
        avg[k] = torch.from_numpy(stack.mean(0))
    return avg


def apply_from_sd(sd):
    from functools import partial

    from multi_style_transfer_gan.models import (
        enhanced_generator_apply,
    )
    from multi_style_transfer_gan.weights import (
        enhanced_generator_from_sd,
    )

    params = enhanced_generator_from_sd(sd)
    return partial(enhanced_generator_apply, params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models_dir", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--selected_dir", required=True)
    ap.add_argument("--n_val", type=int, default=12)
    ap.add_argument("--soup_max", type=int, default=8,
                    help="the soup averages the top-k window of epochs "
                         "ending at the best single checkpoint")
    args = ap.parse_args(argv)

    import torch

    from multi_style_transfer_gan.pipelines import load_generator
    from multi_style_transfer_gan.utils import enable_compilation_cache

    enable_compilation_cache()

    epochs = sorted({int(p.stem.split("_")[-1])
                     for p in Path(args.models_dir).glob("G_AB_epoch_*.pth")})
    print(f"checkpoints: epochs {epochs}")
    report = {"epochs": epochs, "per_direction": {}}
    selected = {}
    for key in ("BA", "AB"):
        inputs, truth = make_eval(key, args.data_root, args.n_val)
        null_ssim = mean_ssim(inputs, truth)
        rows = []
        for e in epochs:
            path = os.path.join(args.models_dir, f"G_{key}_epoch_{e}.pth")
            model = load_generator(path, prefer=f"G_{key}_state_dict")
            outs = forward_u8(model.apply, inputs)
            s = mean_ssim(outs, truth)
            rows.append({"epoch": e, "ssim": round(s, 4)})
            print(f"G_{key} epoch {e}: val SSIM {s:.4f}", flush=True)
        best = max(rows, key=lambda r: r["ssim"])
        # soup: average the up-to-soup_max epochs ENDING at the best one
        idx = next(i for i, r in enumerate(rows)
                   if r["epoch"] == best["epoch"])
        window = [r["epoch"] for r in rows[max(0, idx - args.soup_max + 1)
                                           : idx + 1]]
        soup_paths = [os.path.join(args.models_dir,
                                   f"G_{key}_epoch_{e}.pth")
                      for e in window]
        soup_sd = soup_state_dict(soup_paths, f"G_{key}_state_dict")
        soup_ssim = mean_ssim(forward_u8(apply_from_sd(soup_sd), inputs),
                              truth)
        print(f"G_{key} soup({window}): val SSIM {soup_ssim:.4f} "
              f"(best single {best['ssim']} @ {best['epoch']}; "
              f"identity {null_ssim:.4f})")
        pick_soup = soup_ssim > best["ssim"]
        report["per_direction"][key] = {
            "curve": rows, "identity_ssim": round(null_ssim, 4),
            "best_single": best,
            "soup": {"epochs": window, "ssim": round(soup_ssim, 4)},
            "selected": "soup" if pick_soup else f"epoch_{best['epoch']}",
        }
        if pick_soup:
            selected[key] = {f"G_{key}_state_dict": soup_sd,
                             "epoch": best["epoch"]}
        else:
            src = torch.load(soup_paths[-1], weights_only=False,
                             map_location="cpu")
            selected[key] = {f"G_{key}_state_dict":
                             src[f"G_{key}_state_dict"],
                             "epoch": best["epoch"]}

    os.makedirs(args.selected_dir, exist_ok=True)
    for key, ckpt in selected.items():
        out = os.path.join(args.selected_dir, f"G_{key}_epoch_0.pth")
        torch.save(ckpt, out)
        print(f"exported {out}")
    with open(os.path.join(args.selected_dir, "selection_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v["selected"]
                      for k, v in report["per_direction"].items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
