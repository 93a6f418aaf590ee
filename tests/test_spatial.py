"""Spatially-sharded inference (parallel/spatial.py) vs the unsharded
forward, on the 8-virtual-device CPU mesh (conftest.py).

The assertion is exact-math equivalence: GSPMD partitions the SAME program
(halo exchanges for convs, psum for the norm/GAP reductions), so a height
shard must reproduce the single-device forward to fp32 tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multi_style_transfer_gan.models import (
    enhanced_generator_apply, enhanced_generator_init,
    plain_generator_apply, plain_generator_init,
)
from multi_style_transfer_gan.parallel import spatial_mesh, spatial_apply
from multi_style_transfer_gan.pipelines.model_loader import LoadedModel


def _loaded(kind, params, fwd, channels):
    return LoadedModel(kind=kind, channels=channels, direction=None,
                       params=params, apply=lambda x: fwd(params, x),
                       precision="highest")


@pytest.mark.slow  # r5 re-tier (pytest.ini budget): both widths; the
# plain-generator spatial parity test keeps default-tier sp coverage
@pytest.mark.parametrize("sp", [2, 8])
def test_enhanced_spatial_matches_unsharded(sp):
    params = enhanced_generator_init(jax.random.PRNGKey(0), channels=4,
                                     num_transformer_blocks=1)
    x = jnp.asarray(np.tanh(np.random.default_rng(0)
                            .standard_normal((1, 128, 128, 3))), jnp.float32)
    ref = enhanced_generator_apply(params, x)
    model = _loaded("enhanced", params, enhanced_generator_apply, 4)
    apply = spatial_apply(model, mesh=spatial_mesh(sp))
    out = apply(x)
    # sharded reductions (norm stats / style GAP psum) reorder sums;
    # observed max |d| 2.3e-5 through the tanh output
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_plain_spatial_matches_unsharded():
    params = plain_generator_init(jax.random.PRNGKey(1), channels=8)
    x = jnp.asarray(np.tanh(np.random.default_rng(1)
                            .standard_normal((2, 128, 64, 3))), jnp.float32)
    ref = plain_generator_apply(params, x)
    model = _loaded("plain", params, plain_generator_apply, 8)
    apply = spatial_apply(model, mesh=spatial_mesh(8))
    out = apply(x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_spatial_rejects_undivisible_height():
    params = plain_generator_init(jax.random.PRNGKey(2), channels=8)
    model = _loaded("plain", params, plain_generator_apply, 8)
    apply = spatial_apply(model, mesh=spatial_mesh(8))
    with pytest.raises(ValueError, match="divisible"):
        apply(jnp.zeros((1, 64, 64, 3)))  # 64 % (16*8) != 0


def test_spatial_output_is_height_sharded():
    params = plain_generator_init(jax.random.PRNGKey(3), channels=8)
    model = _loaded("plain", params, plain_generator_apply, 8)
    mesh = spatial_mesh(4)
    apply = spatial_apply(model, mesh=mesh)
    out = apply(jnp.zeros((1, 128, 64, 3)))
    # the output stays sharded on H (no implicit gather to one device)
    assert len(out.sharding.device_set) == 4
