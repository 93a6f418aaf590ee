"""Bootstrap pretrained feature-extractor weights for FID / perceptual loss.

The reference pulls torchvision's pretrained ``inception_v3`` at runtime for
FID (m_test.py:16-34). This build environment has no torchvision and no
network egress, so the framework ships architecture ports plus importers
(metrics/inception.py, train/perceptual.py) and THIS script turns a
torchvision checkpoint into the importer's format. Run it once on any
machine with connectivity (or hand it an already-downloaded file).

Usage:
  # machine with torchvision installed (downloads weights itself):
  python scripts/fetch_feature_weights.py --model inception --out weights/

  # offline machine, checkpoint downloaded separately:
  python scripts/fetch_feature_weights.py --model inception \
      --src ~/Downloads/inception_v3_google-0cc3c7bd.pth --out weights/

Canonical torchvision checkpoint URLs (the 8-hex suffix in each filename is
the SHA256 prefix of the file — torchvision's integrity convention):

  inception_v3 : https://download.pytorch.org/models/inception_v3_google-0cc3c7bd.pth
                 sha256 prefix 0cc3c7bd (IMAGENET1K_V1)
  vgg16        : https://download.pytorch.org/models/vgg16-397923af.pth
                 sha256 prefix 397923af (IMAGENET1K_V1)

After conversion:
  python -m multi_style_transfer_gan.cli.m_test --data_root ... \
      --inception_weights weights/inception_v3_jax.pth
  (FID then uses real InceptionV3 pool features, m_test.py parity.)
For the optional VGG perceptual/Gram extension (train/perceptual.py):
  cyclegan training --extra-loss hooks take weights/vgg16_jax.pth.
"""

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

URLS = {
    "inception": ("https://download.pytorch.org/models/"
                  "inception_v3_google-0cc3c7bd.pth", "0cc3c7bd"),
    "vgg16": ("https://download.pytorch.org/models/vgg16-397923af.pth",
              "397923af"),
}
# key signatures used to sanity-check a user-supplied checkpoint
SIGNATURE_KEYS = {
    "inception": ("Conv2d_1a_3x3.conv.weight", "Mixed_7c.branch_pool.bn.bias"),
    # conv1_1 .. conv4_3 — the deepest layers the JAX trunk consumes
    # (train/perceptual.py _VGG16_CONVS); a full torchvision vgg16 has more
    "vgg16": ("features.0.weight", "features.21.bias"),
}
OUT_NAMES = {"inception": "inception_v3_jax.pth", "vgg16": "vgg16_jax.pth"}


def sha256_of(path, limit=None):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def obtain_state_dict(model, src):
    import torch

    if src:
        print(f"loading {src} (sha256 {sha256_of(src)[:8]}..., expected "
              f"prefix {URLS[model][1]} for the canonical torchvision file)")
        obj = torch.load(src, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return sd
    try:
        import torchvision.models as tvm
    except ImportError:
        raise SystemExit(
            "torchvision is not installed and --src was not given.\n"
            f"Download {URLS[model][0]} on a connected machine and re-run "
            "with --src <file>.")
    if model == "inception":
        net = tvm.inception_v3(weights=tvm.Inception_V3_Weights.IMAGENET1K_V1,
                               aux_logits=True)
    else:
        net = tvm.vgg16(weights=tvm.VGG16_Weights.IMAGENET1K_V1)
    return net.state_dict()


def convert(model, sd, out_dir):
    """Validate keys, strip what the JAX port ignores, save importable .pth."""
    from multi_style_transfer_gan.weights.torch_import import save_pth

    for k in SIGNATURE_KEYS[model]:
        if k not in sd:
            raise SystemExit(
                f"checkpoint does not look like a torchvision {model} "
                f"state_dict: missing key {k!r} (got e.g. "
                f"{sorted(sd)[:3]})")
    import numpy as np

    keep = {}
    for k, v in sd.items():
        if model == "inception" and (k.startswith("AuxLogits")
                                     or k.startswith("fc.")):
            continue
        if model == "vgg16" and k.startswith("classifier."):
            continue
        if k.endswith("num_batches_tracked"):
            continue
        keep[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                             else v)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, OUT_NAMES[model])
    save_pth(keep, out_path)
    print(f"wrote {out_path} ({len(keep)} tensors, "
          f"sha256 {sha256_of(out_path)[:8]}...)")
    return out_path


def probe_images(n=4, size=299):
    """The FIXED validation probe: deterministic images every machine can
    regenerate bit-exactly (PCG64 stream, seed 20260820)."""
    import numpy as np

    return np.random.default_rng(20260820).random((n, size, size, 3),
                                                  np.float32)


def probe_report(feature_fn):
    """Deterministic probe statistics for the cross-implementation
    validation contract (see validate() below): runs the fixed probe
    through the feature fn and returns printable summary numbers plus a
    probe FID between the two halves of the probe batch."""
    import numpy as np

    from multi_style_transfer_gan.metrics.fid import fid_from_features

    feats = np.asarray(feature_fn(probe_images()), np.float64)
    # tile each half to 3 rows so the 2048x2048 covariances are defined
    fa = np.tile(feats[:2], (3, 1)) + np.arange(6)[:, None] * 1e-3
    fb = np.tile(feats[2:], (3, 1)) + np.arange(6)[:, None] * 1e-3
    return {
        "shape": feats.shape,
        "mean": float(feats.mean()),
        "std": float(feats.std()),
        "first8": [round(float(v), 5) for v in feats[0, :8]],
        "probe_fid": float(fid_from_features(fa, fb)),
    }


_TORCH_RECIPE = """\
# Reference recipe (run where torchvision IS installed) — must agree with
# the numbers above to ~1e-3 relative (bilinear-resize kernels and matmul
# reassociation differ at that level). Mirrors m_test.py:16-34 exactly
# (create_feature_extractor('avgpool') INCLUDES the pretrained model's
# internal transform_input step; imagenet-normalize + transform_input
# composes to the port's 2x-1):
#   import numpy as np, torch, torchvision.models as tvm
#   from torchvision.models.feature_extraction import create_feature_extractor
#   net = tvm.inception_v3(weights=tvm.Inception_V3_Weights.IMAGENET1K_V1,
#                          aux_logits=True).eval()
#   fx = create_feature_extractor(net, return_nodes=['avgpool'])
#   x = np.random.default_rng(20260820).random((4, 299, 299, 3), np.float32)
#   t = torch.from_numpy(x).permute(0, 3, 1, 2)
#   t = (t - torch.tensor([0.485, 0.456, 0.406])[:, None, None]) / \\
#       torch.tensor([0.229, 0.224, 0.225])[:, None, None]
#   with torch.no_grad():
#       f = fx(t)['avgpool'].flatten(1)              # pool features, (4, 2048)
#   print(f.mean().item(), f.std().item(), f[0, :8])"""


def validate(model, out_path):
    """Smoke the converted file through the actual JAX consumers AND print
    the deterministic probe numbers that define the offline-validation
    contract. What HAS been validated offline: architecture parity against
    a torch transliteration oracle on synthetic weights, the FID statistic
    against scipy, and this conversion pipeline end-to-end. What has NOT:
    real pretrained weights have never flowed through the port in this
    environment (no egress) — an error shared by port and oracle (both
    written from the torchvision source) would be invisible. Closing that
    gap is this one command on a connected machine: the probe numbers
    printed here must match the torchvision recipe printed below."""
    import numpy as np

    if model == "inception":
        from multi_style_transfer_gan.metrics.inception import (
            make_inception_feature_fn,
        )

        fn = make_inception_feature_fn(out_path)
        feats = fn(np.random.default_rng(0).random((2, 299, 299, 3),
                                                   np.float32))
        assert feats.shape == (2, 2048), feats.shape
        print(f"validated: inception pool features {feats.shape}")
        rep = probe_report(fn)
        print("validation-contract probe (fixed seed 20260820):")
        print(f"  features {rep['shape']}  mean {rep['mean']:.6f}  "
              f"std {rep['std']:.6f}")
        print(f"  first8[img0] {rep['first8']}")
        print(f"  probe FID(half0, half1) = {rep['probe_fid']:.6f}")
        print(_TORCH_RECIPE)
    else:
        from multi_style_transfer_gan.weights.torch_import import load_pth
        from multi_style_transfer_gan.train.perceptual import (
            vgg16_from_torchvision_sd, vgg16_features,
        )

        params = vgg16_from_torchvision_sd(load_pth(out_path))
        import jax.numpy as jnp

        taps = vgg16_features(params, jnp.zeros((1, 64, 64, 3)))
        print(f"validated: vgg16 taps {[t.shape for t in taps]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=["inception", "vgg16", "both"],
                    default="both")
    ap.add_argument("--src", type=str, default=None,
                    help="already-downloaded torchvision checkpoint .pth "
                         "(offline path); omit to download via torchvision")
    ap.add_argument("--out", type=str, default="weights")
    ap.add_argument("--no_validate", action="store_true")
    args = ap.parse_args(argv)

    models = ["inception", "vgg16"] if args.model == "both" else [args.model]
    if args.src and len(models) > 1:
        raise SystemExit("--src converts one file; pick --model explicitly")
    for m in models:
        sd = obtain_state_dict(m, args.src)
        out_path = convert(m, sd, args.out)
        if not args.no_validate:
            validate(m, out_path)


if __name__ == "__main__":
    main()
