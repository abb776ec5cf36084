"""The GP interpolation chain of the local GP-BA in float32 vs float64.

`solver/ba.py _interp_packs` evaluates vmap(gp_pair_pack) then
vmap(gp_interp_pack) (factors/reprojection.py) — the WNOA interpolation of
GaussianProcess.cc:5-44 / G2oTypes.cc:177-223 — as plain jax.numpy left to
XLA. Float32 is the production dtype on the GPU, so the chain must hold its
float64 result inside the f32 envelope, including near-pi rotations, tiny
motions and interval endpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amcslam_tpu.factors import reprojection
from amcslam_tpu.ops import lie

# f32 (eps 1.2e-7) through a chain of a few dozen ops whose GP kernel mixes
# O(dt^3) and O(1/dt^3) terms: measured <= 3.1e-6 on the CPU; 5e-5 leaves
# an order of magnitude for other backends' operation order.
F32_VS_F64_TOL = 5e-5


@jax.jit
def _packs(T1, v1, T2, v2, t1, t2, t):
    packs = jax.vmap(reprojection.gp_pair_pack)(T1, v1, T2, v2)
    return jax.vmap(reprojection.gp_interp_pack)(packs, T1, v1, t1, t2, t)


def _random_case(seed, n, dtype, near_pi=False, tiny=False):
    rng = np.random.default_rng(seed)
    xi1 = rng.normal(scale=0.8, size=(n, 6))
    if near_pi:
        ax = rng.normal(size=(n, 3))
        ax /= np.linalg.norm(ax, axis=1, keepdims=True)
        xi1[:, 3:] = ax * (np.pi - 1e-3)
    if tiny:
        xi1 *= 1e-6
    dxi = rng.normal(scale=(1e-7 if tiny else 0.3), size=(n, 6))
    T1 = jax.vmap(lie.exp_se3)(jnp.asarray(xi1, dtype))
    T2 = jax.vmap(lambda a, b: a @ lie.exp_se3(b))(T1, jnp.asarray(dxi, dtype))
    v1 = jnp.asarray(rng.normal(scale=0.5, size=(n, 6)), dtype)
    v2 = jnp.asarray(rng.normal(scale=0.5, size=(n, 6)), dtype)
    t1 = jnp.asarray(rng.uniform(0.0, 1.0, n), dtype)
    t2 = t1 + jnp.asarray(rng.uniform(0.05, 0.5, n), dtype)
    s = rng.uniform(0.0, 1.0, n)
    s[: n // 4] = 0.0  # interval endpoints
    s[n // 4: n // 2] = 1.0
    t = t1 + jnp.asarray(s, dtype) * (t2 - t1)
    return T1, v1, T2, v2, t1, t2, t


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.mark.parametrize("case", ["generic", "near_pi", "tiny"])
def test_interp_chain_f32_matches_f64(case):
    args64 = _random_case(7, 64, jnp.float64,
                          near_pi=case == "near_pi", tiny=case == "tiny")
    ref = _packs(*args64)
    got = _packs(*(jnp.asarray(a, jnp.float32) for a in args64))
    for k in ("Twb", "Tbw", "Q"):
        assert got[k].dtype == jnp.float32, (case, k)
        assert np.all(np.isfinite(np.asarray(got[k]))), (case, k)
        d = _max_rel(got[k], ref[k])
        assert d < F32_VS_F64_TOL, (case, k, d)


def test_interp_chain_batch_size_independent():
    """Each combo's packs depend on its own inputs only: the first rows of a
    130-combo batch equal a 5-combo batch bit for bit."""
    args = _random_case(11, 130, jnp.float32)
    full = _packs(*args)
    head = _packs(*(a[:5] for a in args))
    for k in ("Twb", "Tbw", "Q"):
        np.testing.assert_array_equal(np.asarray(head[k]),
                                      np.asarray(full[k])[:5])
