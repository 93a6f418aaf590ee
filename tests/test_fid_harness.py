"""FID harness test over a tiny synthetic monet2photo tree (CPU)."""

import os

import pytest

import numpy as np
import torch
from PIL import Image

import torch_oracle as oracle

from multi_style_transfer_gan.pipelines import load_generator
from multi_style_transfer_gan.metrics.fid_harness import run_fid_eval


@pytest.mark.slow
def test_run_fid_eval(tmp_path):
    rng = np.random.default_rng(11)
    root = tmp_path / "monet2photo"
    for dom in ("A", "B"):
        d = root / f"test{dom}"
        d.mkdir(parents=True)
        for i in range(6):
            arr = (rng.random((200, 260, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{dom}{i}.jpg")

    torch.save({"G_AB_state_dict": oracle.make_enhanced_sd(rng, c=4)},
               tmp_path / "gab.pth")
    torch.save({"G_BA_state_dict": oracle.make_enhanced_sd(rng, c=4)},
               tmp_path / "gba.pth")
    g_ab = load_generator(tmp_path / "gab.pth")
    g_ba = load_generator(tmp_path / "gba.pth")

    out_dir = tmp_path / "eval"
    results = run_fid_eval(g_ab, g_ba, root, out_dir, max_images=6, batch=3)
    assert set(results) == {"monet2photo", "photo2monet", "mean"}
    for v in results.values():
        assert np.isfinite(v) and v >= 0
    txt = (out_dir / "test_results.txt").read_text()
    assert "mean FID" in txt
    assert (out_dir / "panels_monet2photo.png").exists()
