"""Drive the ENTIRE product surface with a genuinely trained model.

Protocol: after `cli.train` has produced real
checkpoints at the deployed config (c16, one transformer block, 256^2) on
the synthetic unpaired domains (data/synthetic.py), this harness pushes
those weights through every user-facing surface the reference ships:

  1. checkpoint tooling   : convert_model -> pth_info -> re-import, with a
                            numerical identity check original-vs-converted
  2. single-image CLI     : direct_transform on a test photo
  3. batch CLI            : local_style enhanced at BOTH canvases (256/512)
                            + raw cyclegan mode, both directions
  4. quality study        : complete_comparison (the reference's
                            detailed_metrics_comparison.xlsx shape: 3-sheet
                            xlsx, win counts, verdict) AND
                            compare_image_quality against the known
                            ground-truth folders (the synthetic domains
                            ship monetize(testB) / the renders under testA)
  5. FID harness          : m_test parity — panels + test_results.txt
  6. GUI compare path     : pipelines.compare.compare_models headless
                            (the compare tab's worker)
  7. advanced 5-variant   : generate_with_different_settings — standard/
                            contrast/multiscale/detail/local + grid
                            (advanced_transform.py:38-127)
  8. local-style advanced : the segmentation-driven region-adaptive path
                            (enhanced_local_style.py:178-292) AND the
                            batch CLI's --local_style_mode advanced
                            equalize/guided-filter chain (stage 3)
  9. serving              : the micro-batch HTTP server answering real
                            concurrent requests from the trained model;
                            latency percentiles + img/s + /stats recorded

Prints one summary JSON at the end; artifacts land under --output_dir.

  python scripts/run_trained_surface.py \
      --models_dir runs/r4/models --epoch 240 \
      --data_root data/synth_monet2photo \
      --output_dir runs/r4/surface
"""

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def stage_models(models_dir, epoch, stage_dir):
    """Lay the trained checkpoints out in the reference's fixed-path layout
    (batch_process_images.py:66,91,107). The plain-CycleGAN slot gets a
    dual checkpoint carrying the SAME trained enhanced generators — the
    reference repo ships no trainer for its plain model, and the loaders
    sniff architecture from the keys, so raw `--mode cyclegan` runs the
    trained enhanced weights without post-processing."""
    import torch

    os.makedirs(stage_dir, exist_ok=True)
    ab = os.path.join(models_dir, f"G_AB_epoch_{epoch}.pth")
    ba = os.path.join(models_dir, f"G_BA_epoch_{epoch}.pth")
    shutil.copy2(ab, os.path.join(stage_dir, "G_AB_epoch_200.pth"))
    shutil.copy2(ba, os.path.join(stage_dir, "G_BA_epoch_200.pth"))
    dual = {"epoch": epoch,
            "G_AB_state_dict": torch.load(ab, weights_only=False,
                                          map_location="cpu")
            ["G_AB_state_dict"],
            "G_BA_state_dict": torch.load(ba, weights_only=False,
                                          map_location="cpu")
            ["G_BA_state_dict"]}
    torch.save(dual, os.path.join(stage_dir, "cyclegan_epoch_200.pth"))
    return stage_dir


def convert_roundtrip(stage_dir, out_dir):
    """convert_model + pth_info + re-import == original (tool surface)."""
    import jax.numpy as jnp

    from multi_style_transfer_gan.cli import convert_model, pth_info
    from multi_style_transfer_gan.pipelines import load_generator

    src = os.path.join(stage_dir, "G_BA_epoch_200.pth")
    conv = os.path.join(out_dir, "converted_G_BA.pth")
    convert_model.main(["--input", src, "--output", conv])
    pth_info.main([conv])
    m0 = load_generator(src)
    m1 = load_generator(conv)
    x = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (1, 256, 256, 3)), jnp.float32)
    a = np.asarray(m0.apply(x))
    b = np.asarray(m1.apply(x))
    delta = float(np.abs(a - b).max())
    assert delta == 0.0, f"convert_model changed the forward: {delta}"
    print(f"convert_model roundtrip: identical forward (max |d| {delta})")
    return {"max_delta": delta}


def run_batches(stage_dir, data_root, out_dir):
    from multi_style_transfer_gan.cli import batch_process_images as bpi

    testb = os.path.join(data_root, "testB")
    testa = os.path.join(data_root, "testA")
    runs = [
        # photo -> monet: raw + post-processed, both canvases
        dict(mode="cyclegan", direction="photo2monet", inp=testb, canvas=256),
        dict(mode="local_style", direction="photo2monet", inp=testb,
             canvas=256),
        dict(mode="local_style", direction="photo2monet", inp=testb,
             canvas=512),
        # the segmentation-driven 'advanced' local-style path
        # (enhanced_local_style.py:178-292) — round 5: every local_style
        # mode now consumes trained weights
        dict(mode="local_style", direction="photo2monet", inp=testb,
             canvas=256, ls_mode="advanced"),
        # monet -> photo: raw both canvases (G_AB)
        dict(mode="cyclegan", direction="monet2photo", inp=testa, canvas=256),
        dict(mode="cyclegan", direction="monet2photo", inp=testa, canvas=512),
    ]
    stats = []
    for r in runs:
        sub = os.path.join(out_dir, f"batch_{r['canvas']}")
        t0 = time.time()
        argv = ["--input_dir", r["inp"], "--output_dir", sub,
                "--mode", r["mode"], "--direction", r["direction"],
                "--models_dir", stage_dir, "--bf16",
                "--canvas", str(r["canvas"]),
                "--local_style_mode", r.get("ls_mode", "enhanced")]
        rc = bpi.main(argv)
        assert rc in (0, None), f"batch CLI failed: {argv}"
        stats.append({**{k: v for k, v in r.items() if k != "inp"},
                      "seconds": round(time.time() - t0, 1)})
        print(f"batch done: {r} ({stats[-1]['seconds']}s)")
    return stats


def quality_study(data_root, out_dir):
    """The reference-shaped study + the ground-truth study."""
    from multi_style_transfer_gan.cli import compare_image_quality as ciq
    from multi_style_transfer_gan.metrics.evaluation import (
        complete_comparison,
    )

    b256 = os.path.join(out_dir, "batch_256")
    raw = os.path.join(b256, "cyclegan_photo2monet")
    post = os.path.join(b256, "local_style_enhanced_photo2monet")
    truth = os.path.join(data_root, "truth_monet_for_testB")
    originals = os.path.join(data_root, "testB")

    # (a) reference-shaped 3-folder study (detailed_metrics_comparison.xlsx)
    ref_shape = complete_comparison(
        originals, raw, post, name_a="cyclegan", name_b="localstyle",
        output_dir=os.path.join(out_dir, "study_reference_shape"))
    print(f"reference-shape study: verdict={ref_shape['verdict']}")

    # (b) ground-truth study: compare to the KNOWN target (monetize(testB))
    gt_dir = os.path.join(out_dir, "study_ground_truth")
    os.makedirs(gt_dir, exist_ok=True)
    ciq.main(["--base_dir", truth, "--compare_dirs", raw, post,
              "--output_prefix", "trained_vs_truth",
              "--output_dir", gt_dir])

    # headline numbers for the docs: raw output vs ground truth
    from multi_style_transfer_gan.metrics.evaluation import (
        compare_folder_pair,
    )

    gt_raw = compare_folder_pair(truth, raw)["average"]
    gt_post = compare_folder_pair(truth, post)["average"]
    # and the null baseline: how far is the INPUT photo from the truth?
    gt_null = compare_folder_pair(truth, originals)["average"]
    out = {"reference_shape": {k: ref_shape[k] for k in
                               ("n_images", "verdict", "xlsx")},
           "vs_truth": {"raw": gt_raw, "localstyle": gt_post,
                        "identity_baseline": gt_null}}
    print("vs ground truth:", json.dumps(out["vs_truth"], indent=1,
                                         default=float))
    return out


def fid_harness(stage_dir, data_root, out_dir):
    from multi_style_transfer_gan.cli import m_test

    fid_dir = os.path.join(out_dir, "m_test")
    m_test.main(["--data_root", data_root,
                 "--g_ab", os.path.join(stage_dir, "G_AB_epoch_200.pth"),
                 "--g_ba", os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                 "--output_dir", fid_dir, "--max_images", "54"])
    results = Path(fid_dir, "test_results.txt")
    txt = results.read_text() if results.exists() else "<missing>"
    print("m_test results:\n" + txt)
    return {"test_results": txt}


def gui_compare(stage_dir, data_root, out_dir):
    from multi_style_transfer_gan.pipelines import load_generator
    from multi_style_transfer_gan.pipelines.compare import compare_models

    enh = load_generator(os.path.join(stage_dir, "G_BA_epoch_200.pth"))
    cyc = load_generator(os.path.join(stage_dir, "cyclegan_epoch_200.pth"),
                         prefer="G_BA_state_dict")
    img = sorted(Path(data_root, "testB").iterdir())[0]
    res = compare_models(enh, cyc, str(img),
                         os.path.join(out_dir, "gui_compare"))
    print(f"gui compare-tab worker: {res}")
    return {k: str(v) for k, v in res.items()}


def advanced_variants(stage_dir, data_root, out_dir):
    """The 5-variant advanced_transform surface
    (advanced_transform.py:38-127): standard/contrast/multiscale/detail/
    local variants + the comparison grid, from the trained G_BA."""
    from multi_style_transfer_gan.cli import advanced_transform

    img = str(sorted(Path(data_root, "testB").iterdir())[0])
    adv_dir = os.path.join(out_dir, "advanced_variants")
    advanced_transform.main(["--image", img,
                             "--model",
                             os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                             "--output_dir", adv_dir])
    made = sorted(os.path.basename(p) for p in Path(adv_dir).iterdir())
    assert len(made) >= 6, made  # 5 variants + comparison grid
    print(f"advanced variants: {made}")
    return {"files": made}


def local_style_advanced(stage_dir, data_root, out_dir):
    """The segmentation-driven region-adaptive path
    (enhanced_local_style.py:178-292): from-scratch felzenszwalb
    superpixels + per-region blending, on the trained G_BA."""
    from multi_style_transfer_gan.cli import enhanced_local_style

    img = str(sorted(Path(data_root, "testB").iterdir())[1])
    out = os.path.join(out_dir, "local_style_advanced",
                       "enhanced_local.png")
    enhanced_local_style.main(["--image", img,
                               "--model",
                               os.path.join(stage_dir, "G_BA_epoch_200.pth"),
                               "--output", out])
    assert os.path.exists(out)
    print(f"local-style advanced (segmentation): {out}")
    return {"output": out}


def serving_stage(stage_dir, data_root, out_dir, n_requests=24,
                  concurrency=8):
    """The micro-batch HTTP server answering REAL requests from the
    trained model (serving/server.py): starts it in-process on a free
    port, fires concurrent JPEG POSTs from the test split, records
    latency percentiles + aggregate img/s + /stats, and shuts down."""
    import threading
    import urllib.request

    import jax.numpy as jnp

    from multi_style_transfer_gan.pipelines import load_generator
    from multi_style_transfer_gan.serving import (
        StyleTransferService, serve,
    )

    model = load_generator(os.path.join(stage_dir, "G_BA_epoch_200.pth"))
    service = StyleTransferService(model, canvas=256, max_batch=8,
                                   compute_dtype=jnp.bfloat16)
    server = serve(service, port=0)  # warmup=True compiles the batch shape
    host, port = server.server_address
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    files = sorted(Path(data_root, "testB").iterdir())
    payloads = [files[i % len(files)].read_bytes() for i in range(n_requests)]
    latencies = []
    lock = threading.Lock()
    srv_dir = os.path.join(out_dir, "serving")
    os.makedirs(srv_dir, exist_ok=True)

    def fire(i):
        req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                     data=payloads[i], method="POST")
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
            assert r.status == 200, r.status
        with lock:
            latencies.append(time.time() - t0)
        if i == 0:
            with open(os.path.join(srv_dir, "response_0.png"), "wb") as f:
                f.write(body)

    t0 = time.time()
    threads = []
    for i in range(n_requests):  # bounded client concurrency
        th = threading.Thread(target=fire, args=(i,))
        th.start()
        threads.append(th)
        while sum(th.is_alive() for th in threads) >= concurrency:
            time.sleep(0.005)
    for th in threads:
        th.join()
    wall = time.time() - t0

    with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                timeout=30) as r:
        stats = json.loads(r.read())
    server.shutdown()
    service.close()

    lat = np.sort(latencies)
    res = {"n_requests": n_requests, "concurrency": concurrency,
           "img_s": round(n_requests / wall, 2),
           "latency_p50_s": round(float(lat[len(lat) // 2]), 3),
           "latency_p95_s": round(float(lat[int(len(lat) * 0.95)]), 3),
           "server_stats": stats}
    print("serving:", json.dumps(res, indent=1))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models_dir", required=True)
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--skip", type=str, default="",
                    help="comma list: convert,batch,study,fid,gui,"
                         "advanced,localadv,serving")
    args = ap.parse_args(argv)

    from multi_style_transfer_gan.utils import enable_compilation_cache
    enable_compilation_cache()

    os.makedirs(args.output_dir, exist_ok=True)
    skip = set(args.skip.split(",")) if args.skip else set()
    stage_dir = stage_models(args.models_dir, args.epoch,
                             os.path.join(args.output_dir, "models"))
    summary = {"epoch": args.epoch}
    if "convert" not in skip:
        summary["convert"] = convert_roundtrip(stage_dir, args.output_dir)
    if "batch" not in skip:
        summary["batch"] = run_batches(stage_dir, args.data_root,
                                       args.output_dir)
    if "study" not in skip:
        summary["study"] = quality_study(args.data_root, args.output_dir)
    if "fid" not in skip:
        summary["fid"] = fid_harness(stage_dir, args.data_root,
                                     args.output_dir)
    if "gui" not in skip:
        summary["gui"] = gui_compare(stage_dir, args.data_root,
                                     args.output_dir)
    if "advanced" not in skip:
        summary["advanced_variants"] = advanced_variants(
            stage_dir, args.data_root, args.output_dir)
    if "localadv" not in skip:
        summary["local_style_advanced"] = local_style_advanced(
            stage_dir, args.data_root, args.output_dir)
    if "serving" not in skip:
        summary["serving"] = serving_stage(stage_dir, args.data_root,
                                           args.output_dir)
    path = os.path.join(args.output_dir, "surface_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1, default=float)
    print(f"\nsummary written: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
