"""Per-frame pose-velocity optimization (the tracking-time solver).

JAX rebuild of `Optimizer::PoseGPOptimizationFromeLastFrame`
(Optimizer.cc:369-686): two 12-dof pose-velocity vertices (previous frame —
optionally fixed — and current frame), connected by

  * one GP motion prior with information QiInv(dt)  (no robust kernel)
  * a vertical-velocity regularizer on each vertex (info = QcInv[2,2])
  * per-feature reprojection edges:
      - async cameras  -> GP-interpolated mono reprojection (both vertices)
      - stereo camera  -> mono/stereo reprojection (current vertex only)
    each with Huber kernel (delta = sqrt(5.991) mono / sqrt(7.815) stereo)
    and information invLevelSigma2 / uncertainty2.

Runs g2o's schedule: 4 rounds x optimize(10) with chi2-based outlier
re-leveling between rounds (chi2Mono = 5.991, chi2Stereo = {15.6, 9.8,
7.815, 7.815}, close-point relaxation x1.5, depth-positivity) and the Huber
kernel dropped after round 2 (Optimizer.cc:548-675). The whole schedule is
one jitted program over padded SoA edge arrays; dynamic outlier sets are
per-edge masks, not graph rebuilds.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..factors import gp_prior, priors, reprojection
from ..ops import lie
from . import robust
from .lm import LMProblem, lm_optimize

CHI2_MONO = (5.991, 5.991, 5.991, 5.991)
CHI2_STEREO = (15.6, 9.8, 7.815, 7.815)
TH_HUBER_MONO = float(np.sqrt(5.991))
TH_HUBER_STEREO = float(np.sqrt(7.815))


class PoseGPData(NamedTuple):
    """SoA problem data for one per-frame solve (static shapes, padded)."""

    # endpoint metadata
    t_prev: jax.Array            # scalar
    t_cur: jax.Array             # scalar
    qi_inv: jax.Array            # (12,12) GP prior information
    qcinv22: jax.Array           # scalar, velocity-edge information
    fix_prev: jax.Array          # () bool — vertex 0 fixed
    # camera rig
    Tbc: jax.Array               # (C,4,4) camera-to-body extrinsics
    K: jax.Array                 # (C,4) pinhole intrinsics (fx,fy,cx,cy)
    bf: jax.Array                # scalar stereo baseline*fx
    # async-camera GP edges (padded to Nm)
    mg_obs: jax.Array            # (Nm,2)
    mg_Xw: jax.Array             # (Nm,3)
    mg_t: jax.Array              # (Nm,)
    mg_cam: jax.Array            # (Nm,) int32
    mg_w: jax.Array              # (Nm,) invSigma2
    mg_valid: jax.Array          # (Nm,) bool — padding mask
    mg_close: jax.Array          # (Nm,) bool — trackDepth < 10
    # stereo-camera edges at t_cur (padded to Ns); mono rows have ur<0 and
    # residual/Jacobian row 2 zeroed
    st_obs: jax.Array            # (Ns,3) (u,v,ur)
    st_Xw: jax.Array             # (Ns,3)
    st_w: jax.Array              # (Ns,)
    st_valid: jax.Array          # (Ns,) bool
    st_is_stereo: jax.Array      # (Ns,) bool (ur >= 0)
    st_close: jax.Array          # (Ns,) bool
    # optional interp-combo table: every async camera fires once per frame
    # (Frame.cc:200-207), so all its features share one interpolation time —
    # the GP chain is evaluated once per unique time and gathered per edge.
    mg_it: jax.Array | None = None   # (Nm,) int32 index into it_t
    it_t: jax.Array | None = None    # (U,) unique interpolation times


class PoseState(NamedTuple):
    T: jax.Array  # (2,4,4) body-to-world poses [prev, cur]
    v: jax.Array  # (2,6) world twists


def _mono_gp_all(data: PoseGPData, state: PoseState):
    """vmapped residual+jacobians of all async-camera GP edges."""
    if data.mg_it is not None:
        pack = reprojection.gp_pair_pack(
            state.T[0], state.v[0], state.T[1], state.v[1]
        )
        ips = jax.vmap(
            lambda t: reprojection.gp_interp_pack(
                pack, state.T[0], state.v[0], data.t_prev, data.t_cur, t
            )
        )(data.it_t)
        from .ba import _onehot_gather

        U = data.it_t.shape[0]
        C = data.Tbc.shape[0]
        # one-hot gathers from these small tables (see ba._onehot_gather;
        # exact only under HIGHEST matmul precision)
        ip_e = jax.tree.map(lambda a: _onehot_gather(data.mg_it, U, a), ips)
        Tbc_e = _onehot_gather(data.mg_cam, C, data.Tbc)
        K_e = _onehot_gather(data.mg_cam, C, data.K)

        def one_it(ip, Tbc, Kc, obs, Xw):
            r, J1, J2, _, _, Xc = reprojection.mono_gp_residual_jac_interp(
                ip, Tbc, Kc, Xw, obs
            )
            return r, J1, J2, Xc

        r, J1, J2, Xc = jax.vmap(one_it)(
            ip_e, Tbc_e, K_e, data.mg_obs, data.mg_Xw
        )
        return r, J1, J2, Xc[:, 2]

    def one(obs, Xw, t, cam):
        return reprojection.mono_gp_residual_jac(
            state.T[0], state.v[0], data.t_prev,
            state.T[1], state.v[1], data.t_cur,
            t, data.Tbc[cam], data.K[cam], Xw, obs,
        )

    r, J1, J2, _, _, Xc = jax.vmap(one)(data.mg_obs, data.mg_Xw, data.mg_t, data.mg_cam)
    return r, J1, J2, Xc[:, 2]


def _stereo_all(data: PoseGPData, state: PoseState):
    """vmapped residual+jacobians of stereo-camera edges (unary on cur)."""
    Tbc = data.Tbc[-1]
    K = data.K[-1]

    def one(obs, Xw, is_stereo):
        r3, J3, _, Xc = reprojection.stereo_residual_jac(
            state.T[1], Tbc, K, data.bf, Xw, obs
        )
        row_mask = jnp.where(
            is_stereo, jnp.ones(3, r3.dtype), jnp.asarray([1.0, 1.0, 0.0], r3.dtype)
        )
        return r3 * row_mask, J3 * row_mask[:, None], Xc[2]

    return jax.vmap(one)(data.st_obs, data.st_Xw, data.st_is_stereo)


def _edge_chi2(r, w):
    return w * jnp.sum(r * r, axis=-1)


def make_problem(data: PoseGPData, lvl_m, lvl_s, huber_on: bool) -> LMProblem:
    """LMProblem closures for the current outlier-level masks."""
    dtype = data.mg_obs.dtype
    act_m = data.mg_valid & lvl_m
    act_s = data.st_valid & lvl_s
    delta_s = jnp.where(
        data.st_is_stereo,
        jnp.asarray(TH_HUBER_STEREO, dtype),
        jnp.asarray(TH_HUBER_MONO, dtype),
    )

    def chi2(state: PoseState):
        r_m, _, _, _ = _mono_gp_all(data, state)
        s_m = _edge_chi2(r_m, data.mg_w)
        rho0_m, _ = robust.huber_rho01(
            s_m, jnp.asarray(TH_HUBER_MONO, dtype), huber_on
        )
        c_m = jnp.sum(jnp.where(act_m, rho0_m, 0.0))

        r_s, _, _ = _stereo_all(data, state)
        s_s = _edge_chi2(r_s, data.st_w)
        rho0_s, _ = robust.huber_rho01(s_s, delta_s, huber_on)
        c_s = jnp.sum(jnp.where(act_s, rho0_s, 0.0))

        r_gp = gp_prior.gp_prior_residual(
            state.T[0], state.v[0], data.t_prev, state.T[1], state.v[1], data.t_cur
        )
        c_gp = r_gp @ data.qi_inv @ r_gp
        c_vel = data.qcinv22 * (state.v[0, 2] ** 2 + state.v[1, 2] ** 2)
        return c_m + c_s + c_gp + c_vel

    def linearize(state: PoseState):
        H = jnp.zeros((24, 24), dtype)
        b = jnp.zeros((24,), dtype)

        # --- mono GP edges (binary: vertices 0 and 1)
        r_m, J1, J2, _ = _mono_gp_all(data, state)
        # NaN-safe masking of padded/invalid edges (NaN * 0 = NaN otherwise)
        m3 = act_m[:, None]
        r_m = jnp.where(m3, r_m, 0.0)
        J1 = jnp.where(m3[..., None], J1, 0.0)
        J2 = jnp.where(m3[..., None], J2, 0.0)
        s_m = _edge_chi2(r_m, data.mg_w)
        _, rho1_m = robust.huber_rho01(s_m, jnp.asarray(TH_HUBER_MONO, dtype), huber_on)
        w_m = jnp.where(act_m, data.mg_w * rho1_m, 0.0)  # (Nm,)
        J = jnp.concatenate([J1, J2], axis=2)  # (Nm,2,24)
        JW = J * w_m[:, None, None]
        H = H + jnp.einsum("eri,erj->ij", JW, J)
        b = b - jnp.einsum("eri,er->i", JW, r_m)

        # --- stereo-camera edges (unary on vertex 1)
        r_s, J3, _ = _stereo_all(data, state)
        m3 = act_s[:, None]
        r_s = jnp.where(m3, r_s, 0.0)
        J3 = jnp.where(m3[..., None], J3, 0.0)
        s_s = _edge_chi2(r_s, data.st_w)
        _, rho1_s = robust.huber_rho01(s_s, delta_s, huber_on)
        w_s = jnp.where(act_s, data.st_w * rho1_s, 0.0)
        JsW = J3 * w_s[:, None, None]
        H = H.at[12:, 12:].add(jnp.einsum("eri,erj->ij", JsW, J3))
        b = b.at[12:].add(-jnp.einsum("eri,er->i", JsW, r_s))

        # --- GP prior (full 12x12 information, no robust kernel)
        r_gp, Jg1, Jg2 = gp_prior.gp_prior_residual_jac(
            state.T[0], state.v[0], data.t_prev, state.T[1], state.v[1], data.t_cur
        )
        Jg = jnp.concatenate([Jg1, Jg2], axis=1)  # (12,24)
        JgW = data.qi_inv @ Jg
        H = H + Jg.T @ JgW
        b = b - JgW.T @ r_gp

        # --- velocity edges (unary, 1-dim, info qcinv22)
        for vi in range(2):
            o = 12 * vi
            H = H.at[o + 8, o + 8].add(data.qcinv22)
            b = b.at[o + 8].add(-data.qcinv22 * state.v[vi, 2])

        # fixed-vertex masking: zero vertex-0 rows/cols when fix_prev
        act = jnp.concatenate(
            [jnp.where(data.fix_prev, 0.0, 1.0) * jnp.ones(12, dtype), jnp.ones(12, dtype)]
        )
        H = H * act[:, None] * act[None, :]
        b = b * act
        return H, b, act

    def max_abs_diag(lin):
        H, b, act = lin
        return jnp.max(jnp.abs(jnp.diagonal(H)) * act)

    def solve(lin, lam):
        H, b, act = lin
        Hd = H + jnp.diag(lam * act + (1.0 - act))
        L, lower = jax.scipy.linalg.cho_factor(Hd)
        dx = jax.scipy.linalg.cho_solve((L, lower), b)
        return dx, dx @ dx, dx @ b

    def retract(state: PoseState, dx):
        d = dx.reshape(2, 12)
        T = jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.T, d[:, :6])
        return PoseState(T=T, v=state.v + d[:, 6:])

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def pose_gp_optimize(data: PoseGPData, state: PoseState, outlier_m0, outlier_s0):
    """The full 4-round schedule. Returns (state, inlier_m, inlier_s, stats).

    outlier_*0: initial per-edge outlier flags (pFrame->mvbOutlier).
    """
    lvl_m = ~outlier_m0
    lvl_s = ~outlier_s0
    round_stats = []

    for it in range(4):
        huber_on = it != 3
        problem = make_problem(data, lvl_m, lvl_s, huber_on)
        state, stats = lm_optimize(problem, state, num_iterations=10)
        round_stats.append(stats)

        # Re-classification at the new state (Optimizer.cc:575-675).
        r_m, _, _, z_m = _mono_gp_all(data, state)
        chi_m = _edge_chi2(r_m, data.mg_w)
        chi2close = 1.5 * CHI2_MONO[it]
        bad_m = (
            ((chi_m > CHI2_MONO[it]) & ~data.mg_close)
            | (data.mg_close & (chi_m > chi2close))
            | (z_m <= 0)
        )
        lvl_m = data.mg_valid & ~bad_m

        r_s, _, z_s = _stereo_all(data, state)
        chi_s = _edge_chi2(r_s, data.st_w)
        bad_stereo = chi_s > CHI2_STEREO[it]
        bad_mono = (
            ((chi_s > CHI2_MONO[it]) & ~data.st_close)
            | (data.st_close & (chi_s > chi2close))
            | (z_s <= 0)
        )
        bad_s = jnp.where(data.st_is_stereo, bad_stereo, bad_mono)
        lvl_s = data.st_valid & ~bad_s

    n_inliers = jnp.sum(lvl_m) + jnp.sum(lvl_s)
    return state, lvl_m, lvl_s, (round_stats, n_inliers)
