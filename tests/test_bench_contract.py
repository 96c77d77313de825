"""bench.py helpers: spread stats and the benchmark target. The
measurement paths need the GPU; these guard the glue the JSON line
depends on."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402  (repo-root module)


def test_spread_median_min_max():
    med, spread = bench._spread([3.0, 1.0, 2.0])
    assert med == 2.0
    assert spread == {"median": 2.0, "min": 1.0, "max": 3.0, "n": 3}


def test_target_is_mxu_shaped():
    """The bench target must stay a BATCHED matmul logp (the matmul path
    the headline number depends on)."""
    import jax.numpy as jnp

    dim, logp = bench._target(jnp)
    assert dim == 10
    out = logp(jnp.zeros((4, dim)))
    assert out.shape == (4,)
    assert np.allclose(np.asarray(out), 0.0)
