"""Headless tests of the GUI tab worker chains (gui/app.py).

The reference GUI's processing logic lives in per-tab worker threads
(gan_login_gui.py:769-907, :1259-1530, :1814-1898); ours are module-level
functions the tkinter closures delegate to, so the full image->model->
post-chain->save path is testable without a display.
"""

import numpy as np
import pytest
from PIL import Image

from multi_style_transfer_gan.gui.app import (
    _process_cyclegan, _process_local, _process_standard,
)


class _StubModel:
    """LoadedModel stand-in: apply maps [-1,1] -> [-1,1] deterministically."""

    kind = "enhanced"

    def apply(self, x):
        import jax.numpy as jnp

        return jnp.clip(-0.5 * x + 0.1, -1.0, 1.0)


@pytest.fixture
def img_path(tmp_path):
    rng = np.random.default_rng(3)
    arr = (rng.random((200, 300, 3)) * 255).astype(np.uint8)
    p = tmp_path / "in.jpg"
    Image.fromarray(arr).save(p)
    return str(p)


def _check_output(out_path, w=300, h=200):
    img = Image.open(out_path)
    assert img.size == (w, h)  # aspect restored (<=1MP input)
    a = np.asarray(img)
    assert a.dtype == np.uint8 and a.std() > 0


def test_process_standard(img_path, tmp_path):
    out = str(tmp_path / "o" / "std.png")
    got = _process_standard(_StubModel(), img_path, out, blend_original=0.3,
                            fix_blocks=True, strength=0.8, smooth=2,
                            enhance_colors=True, direction="photo2monet")
    assert got == out
    _check_output(out)


def test_process_standard_monet2photo_no_extras(img_path, tmp_path):
    out = str(tmp_path / "std2.png")
    _process_standard(_StubModel(), img_path, out, blend_original=0.0,
                      fix_blocks=False, strength=0.5, smooth=0,
                      enhance_colors=True, direction="monet2photo")
    _check_output(out)


@pytest.mark.parametrize("mode", ["simple", "enhanced", "advanced"])
def test_process_local_modes(img_path, tmp_path, mode):
    out = str(tmp_path / f"local_{mode}.png")
    _process_local(_StubModel(), img_path, out, mode=mode, strength=0.5,
                   detail=0.6)
    _check_output(out)


def test_process_cyclegan(img_path, tmp_path):
    out = str(tmp_path / "cyc.png")
    _process_cyclegan(_StubModel(), img_path, out)
    _check_output(out)


def test_thumb_headless_returns_none(img_path):
    # without a Tk root / display, preview rendering degrades to None
    # instead of raising into the worker thread
    from multi_style_transfer_gan.gui.app import _thumb

    _thumb(img_path)  # must not raise even with no display
    assert _thumb("/nonexistent.png") is None


def test_process_standard_adaptive_smooth_gate(img_path, tmp_path):
    # adaptive_smooth=False must skip the Gaussian even with smooth>0
    # (gan_login_gui.py:858-864)
    import numpy as np
    from PIL import Image

    out_a = str(tmp_path / "sm_on.png")
    out_b = str(tmp_path / "sm_off.png")
    _process_standard(_StubModel(), img_path, out_a, strength=0.5, smooth=5,
                      enhance_colors=False, adaptive_smooth=True)
    _process_standard(_StubModel(), img_path, out_b, strength=0.5, smooth=5,
                      enhance_colors=False, adaptive_smooth=False)
    a = np.asarray(Image.open(out_a), np.float32)
    b = np.asarray(Image.open(out_b), np.float32)
    assert np.abs(a - b).mean() > 0.5  # blur changed the output


def test_process_local_toggles(img_path, tmp_path):
    # sky/colors/smooth toggles change the enhanced-mode output
    # (gan_login_gui.py:1334,1410-1423)
    import numpy as np
    from PIL import Image

    outs = {}
    for name, kw in (
        ("all_on", {}),
        ("no_smooth", {"smooth_transitions": False}),
        ("no_colors", {"smooth_transitions": False, "enhance_colors": False}),
    ):
        p = str(tmp_path / f"{name}.png")
        _process_local(_StubModel(), img_path, p, mode="enhanced",
                       strength=0.5, detail=0.6, **kw)
        outs[name] = np.asarray(Image.open(p), np.float32)
    assert np.abs(outs["all_on"] - outs["no_smooth"]).mean() > 0.1
    assert np.abs(outs["no_smooth"] - outs["no_colors"]).mean() > 0.1


@pytest.mark.slow
def test_model_info_text_headless():
    """debug_check_model parity panel (gan_login_gui.py:280-298):
    per-model load state, family, width, parameter/tensor counts."""
    import jax

    from multi_style_transfer_gan.gui.app import (
        ModelManager, model_info_text,
    )
    from multi_style_transfer_gan.models import enhanced_generator_init
    from multi_style_transfer_gan.pipelines.model_loader import (
        LoadedModel,
    )

    mgr = ModelManager()
    params = enhanced_generator_init(jax.random.PRNGKey(0), channels=4,
                                     num_transformer_blocks=1)
    mgr.enhanced_ab = LoadedModel(kind="enhanced", channels=4,
                                  direction="AB", params=params,
                                  apply=lambda x: x)
    text = model_info_text(mgr)
    assert "enhanced_ab: kind=enhanced  channels=4" in text
    assert "children: " in text and "initial" in text and "down1" in text
    n_params = sum(int(np.prod(np.shape(v))) for v in params.values())
    assert f"params={n_params:,}" in text
    for missing in ("enhanced_ba", "cyclegan_ab", "cyclegan_ba"):
        assert f"{missing}: NOT loaded" in text
