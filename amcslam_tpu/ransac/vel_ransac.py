"""MC-RANSAC: velocity-model RANSAC for async multi-camera outlier removal.

Rebuild of `Tracking::MCRansac` (Tracking.cc:1939-2002) +
`Optimizer::OptimizeVel` (Optimizer.cc:2364-2447) — the paper's asynchronous
outlier-rejection stage. Per hypothesis: fit a 6-dof body twist to 3 sampled
matches by LM (40 iterations, Huber delta = 5.991, information
invLevelSigma2), residual model

    err = obs - pi_cam( (T_last exp(v dt) Tbc[cam])^-1 Xw ),  dt = t_obs - t_last

then count inliers over ALL matches with ||err|| <= threshold (default 3 px
from YAML `Ransac.threshold`). Here the reference's serial hypothesis
loop becomes one vmapped program — every hypothesis optimizes and scores in
parallel on device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
from functools import partial
import jax.numpy as jnp

from ..factors import priors
from ..solver import robust
from ..solver.lm import LMProblem, lm_optimize

HUBER_DELTA = 5.991  # Optimizer.cc:2410


class VelRansacData(NamedTuple):
    T_last: jax.Array   # (4,4) last frame body-to-world pose
    v0: jax.Array       # (6,) initial velocity (current frame estimate)
    dt: jax.Array       # (N,) per-match t_obs(cam) - t_last
    Xw: jax.Array       # (N,3) world points
    obs: jax.Array      # (N,2) current-frame observations
    cam: jax.Array      # (N,) int32
    w: jax.Array        # (N,) invLevelSigma2
    valid: jax.Array    # (N,) bool
    Tbc: jax.Array      # (C,4,4)
    K: jax.Array        # (C,4)


def _residuals_all(v, data: VelRansacData):
    def one(dt, Xw, obs, cam):
        return priors.vel_reproj_jac(
            v, data.T_last, dt, data.Tbc[cam], data.K[cam], Xw, obs
        )

    r, J = jax.vmap(one)(data.dt, data.Xw, data.obs, data.cam)
    return r, J


def _fit_velocity(data: VelRansacData, sample_mask, num_iterations=40):
    """LM fit of the twist on the edges selected by sample_mask (others are
    level-1: present but inactive — OptimizeVel semantics)."""
    dtype = data.obs.dtype
    act = data.valid & sample_mask
    delta = jnp.asarray(HUBER_DELTA, dtype)

    def chi2(v):
        r, _ = _residuals_all(v, data)
        r = jnp.where(act[:, None], r, 0.0)
        s = jnp.sum(r * r, -1) * data.w
        rho0, _ = robust.huber_rho01(s, delta, True)
        return jnp.sum(jnp.where(act, rho0, 0.0))

    def linearize(v):
        r, J = _residuals_all(v, data)
        m = act[:, None]
        r = jnp.where(m, r, 0.0)
        J = jnp.where(m[..., None], J, 0.0)
        s = jnp.sum(r * r, -1) * data.w
        _, rho1 = robust.huber_rho01(s, delta, True)
        w = jnp.where(act, data.w * rho1, 0.0)
        H = jnp.einsum("eri,e,erj->ij", J, w, J)
        b = -jnp.einsum("eri,e,er->i", J, w, r)
        return H, b

    problem = LMProblem(
        chi2=chi2,
        linearize=linearize,
        max_abs_diag=lambda lin: jnp.max(jnp.abs(jnp.diagonal(lin[0]))),
        solve=lambda lin, lam: (
            lambda dx: (dx, dx @ dx, dx @ lin[1])
        )(jnp.linalg.solve(lin[0] + lam * jnp.eye(6, dtype=dtype), lin[1])),
        retract=lambda v, dx: v + dx,
    )
    v, stats = lm_optimize(problem, data.v0, num_iterations)
    return v


def optimize_vel(data: VelRansacData, sample_mask, num_iterations: int = 40):
    """Public OptimizeVel parity (Optimizer.cc:2364-2447): LM twist fit on the
    level-0 (sampled) edges, then ||error|| <= threshold inliers over all.
    Returns (vel, residual_norms)."""
    v = _fit_velocity(data, sample_mask, num_iterations)
    r, _ = _residuals_all(v, data)
    return v, jnp.linalg.norm(r, axis=-1)


@partial(jax.jit, static_argnames=("threshold", "min_match"))
def mc_ransac(
    data: VelRansacData,
    samples: jax.Array,
    threshold: float = 3.0,
    min_match: int = 30,
):
    """All hypotheses in parallel. samples: (H,3) int32 indices.
    Jitted with a def-time cache: per-frame re-tracing dominated the host
    profile when the wrapper was rebuilt per call.

    Returns (ok, best_vel, best_inlier_mask, best_count). `ok` is False when
    the best hypothesis has fewer than `min_match` inliers (caller then skips
    outlier marking, Tracking.cc:1987-1988).
    """
    def hypo(idx):
        # fit on the 3 SAMPLED edges only, as the reference does (g2o puts
        # the non-sampled edges on level 1, so optimize(40) never touches
        # them — Optimizer.cc:2394-2423); the previous full-N masked
        # linearize cost 40 LM iterations x N-row GP chains per hypothesis
        # (655 ms/frame on the CPU e2e profile, dominated TrackLocalMap)
        sub = data._replace(
            dt=data.dt[idx], Xw=data.Xw[idx], obs=data.obs[idx],
            cam=data.cam[idx], w=data.w[idx], valid=data.valid[idx],
        )
        v = _fit_velocity(sub, jnp.ones(idx.shape[0], bool))
        r, _ = _residuals_all(v, data)
        norms = jnp.linalg.norm(r, axis=-1)
        inl = data.valid & (norms <= threshold)
        return v, inl, jnp.sum(inl)

    v_h, inl_h, n_h = jax.vmap(hypo)(samples)
    best = jnp.argmax(n_h)
    ok = n_h[best] >= min_match
    return ok, v_h[best], inl_h[best], n_h[best]
