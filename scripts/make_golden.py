"""Regenerate the trained-checkpoint golden (tests/test_trained_checkpoint.py).

Run whenever trained/G_BA_selected.pth is replaced by a newly selected
checkpoint; uses the test's exact probe recipe and stores fp16.

  PYTHONPATH=/root/repo:$PYTHONPATH python scripts/make_golden.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import jax
import jax.numpy as jnp

# The golden must be generated on the platform the default test tier runs
# on (tests/conftest.py: the CPU), so pin it here.
jax.config.update("jax_platforms", "cpu")


def main():
    from multi_style_transfer_gan.data.synthetic import render_photo
    from multi_style_transfer_gan.ops import (
        from_model_range, to_model_range,
    )
    from multi_style_transfer_gan.pipelines.model_loader import (
        load_generator,
    )

    m = load_generator("trained/G_BA_selected.pth")
    img = render_photo(900100, size=128)
    x = to_model_range(jnp.asarray(img, jnp.float32) / 255.0)[None]
    y = np.asarray(from_model_range(m.apply(x))[0], np.float32)
    np.save("trained/golden_gba_128.npy", y.astype(np.float16))
    inp01 = np.asarray(img, np.float32) / 255.0
    print(f"golden saved: shape {y.shape}, mean |out-in| "
          f"{np.abs(y - inp01).mean():.4f}")


if __name__ == "__main__":
    main()
