"""Golden regression on the committed trained checkpoints (trained/).

Pins the WHOLE import -> build -> forward chain on genuinely trained
weights (docs/TRAINED_STUDY.md): a deterministic synthetic probe scene
through G_BA must reproduce the committed fp16 golden to cross-platform
conv tolerance. Random-init parity tests can miss scale-dependent bugs;
this one can't.
"""

import numpy as np
import pytest

import jax.numpy as jnp

TRAINED = "trained/G_BA_selected.pth"
GOLDEN = "trained/golden_gba_128.npy"


def test_trained_checkpoint_forward_matches_golden():
    import os

    for p in (TRAINED, GOLDEN):
        assert os.path.exists(p), f"missing committed artifact {p}"
    from multi_style_transfer_gan.data.synthetic import render_photo
    from multi_style_transfer_gan.ops import (
        from_model_range, to_model_range,
    )
    from multi_style_transfer_gan.pipelines.model_loader import (
        load_generator,
    )

    m = load_generator(TRAINED)
    assert m.kind == "enhanced" and m.channels == 16
    img = render_photo(900100, size=128)
    x = to_model_range(jnp.asarray(img, jnp.float32) / 255.0)[None]
    y = np.asarray(from_model_range(m.apply(x))[0], np.float32)
    golden = np.load(GOLDEN).astype(np.float32)
    # fp16 golden quantization (~5e-4) + cross-platform conv reassociation
    np.testing.assert_allclose(y, golden, atol=5e-3, rtol=0)
    # and the output is a real translation, not a passthrough
    inp01 = np.asarray(img, np.float32) / 255.0
    assert np.abs(y - inp01).mean() > 0.01
