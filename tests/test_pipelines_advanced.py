"""Advanced / local-style / compare pipeline tests (CPU)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_oracle as oracle

from multi_style_transfer_gan.pipelines import load_generator
from multi_style_transfer_gan.pipelines.advanced import (
    generate_with_different_settings,
)
from multi_style_transfer_gan.pipelines.local_style import (
    enhanced_local_style_transfer, get_segmentation_mask, analyze_segments,
    determine_blend_ratios,
)
from multi_style_transfer_gan.pipelines.compare import compare_models


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    rng = np.random.default_rng(9)
    d = tmp_path_factory.mktemp("m")
    torch.save({"G_AB_state_dict": oracle.make_enhanced_sd(rng, c=4)},
               d / "enh.pth")
    torch.save({"G_AB_state_dict": oracle.make_plain_sd(rng, c=8)},
               d / "plain.pth")
    return (load_generator(d / "enh.pth"),
            load_generator(d / "plain.pth"))


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    rng = np.random.default_rng(10)
    p = tmp_path_factory.mktemp("img") / "photo.jpg"
    yy, xx = np.mgrid[0:200, 0:300]
    img = np.stack([(np.sin(xx / 40) + 1) * 100,
                    (np.cos(yy / 30) + 1) * 90,
                    np.full_like(xx, 120)], -1)
    img[:70] = [200, 205, 215]  # sky
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(p)
    return p


@pytest.mark.slow  # the CLI smoke test drives the same five variants
def test_advanced_five_variants(models, photo, tmp_path):
    enh, _ = models
    results = generate_with_different_settings(enh, photo, tmp_path)
    assert set(results) == {"standard", "contrast", "multiscale", "detail",
                            "local"}
    for name, path in results.items():
        img = Image.open(path)
        assert img.size == (256, 256), name
    assert os.path.exists(tmp_path / "enhanced_comparison.jpg")


def test_local_style_pipeline(models, photo, tmp_path):
    enh, _ = models
    out = enhanced_local_style_transfer(enh, photo, tmp_path / "ls.png")
    assert out.size == (300, 200)  # restored aspect (source < 1MP)
    assert os.path.exists(tmp_path / "comparison.jpg")


def test_segment_analysis_blend_map(photo):
    img = np.asarray(Image.open(photo).resize((128, 128)))
    segs = get_segmentation_mask(img)
    assert segs.shape == (128, 128)
    stats = analyze_segments(img, segs)
    assert len(stats) == len(np.unique(segs))
    bm = determine_blend_ratios(stats, segs, img.shape)
    assert bm.shape == (128, 128)
    assert 0.0 <= bm.min() and bm.max() <= 0.95  # clamped to [0.3,0.9]+blur


def test_compare_pipeline(models, photo, tmp_path):
    enh, plain = models
    out = compare_models(enh, plain, photo, tmp_path)
    for k in ("enhanced", "cyclegan", "figure"):
        assert os.path.exists(out[k]), k


@pytest.mark.slow
def test_graft_entry_multichip():
    import __graft_entry__ as g

    # 8 virtual CPU devices from conftest; the pooled fakes are generator
    # outputs in [-1, 1], equal up to float32 reassociation
    _, pool_delta = g.dryrun_multichip(8)
    assert pool_delta <= 1e-4, pool_delta
