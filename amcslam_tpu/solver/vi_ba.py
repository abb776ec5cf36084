"""Visual-inertial bundle adjustment (BASELINE config 4).

The reference fork deleted ORB-SLAM3's inertial optimizers but kept the
preintegration machinery (SURVEY.md §2.12); this module provides the
inertial BA the benchmark suite requires: per-keyframe inertial states
(R, p, v) + gyro/accel biases, preintegrated IMU factors between consecutive
keyframes, bias random-walk factors, and mono reprojection edges against
free landmarks. Small windows solve densely (poses + landmarks jointly);
the landmark axis can reuse the Schur machinery of solver/ba.py when scaled.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..factors import imu as imu_factor
from ..factors.imu import InertialState, imu_residual_jac, retract_inertial
from ..factors.reprojection import project_pinhole, project_jac_pinhole
from ..ops import imu, lie
from . import robust
from .lm import LMProblem, lm_optimize


class VIBAData(NamedTuple):
    # IMU factors between consecutive KFs (K-1 of them, padded allowed)
    pre: imu.PreintState        # batched PreintState, leading dim (Ki,)
    imu_pairs: jax.Array        # (Ki,2) int32
    imu_valid: jax.Array        # (Ki,) bool
    bg_lin: jax.Array           # (Ki,3) linearization bias of each window
    ba_lin: jax.Array           # (Ki,3)
    walk_info: jax.Array        # (6,6) bias random-walk information per step
    gravity: jax.Array          # (3,)
    # reprojection edges
    obs: jax.Array              # (E,2)
    obs_kf: jax.Array           # (E,) int32
    obs_lm: jax.Array           # (E,) int32
    obs_cam: jax.Array          # (E,) int32
    w: jax.Array                # (E,)
    obs_valid: jax.Array        # (E,) bool
    Tbc: jax.Array              # (C,4,4)
    K_intr: jax.Array           # (C,4)
    pose_fixed: jax.Array       # (K,) bool
    huber_mono: float = 2.447   # sqrt(5.991)


class VIBAState(NamedTuple):
    R: jax.Array   # (K,3,3)
    p: jax.Array   # (K,3)
    v: jax.Array   # (K,3)
    bg: jax.Array  # (K,3)
    ba: jax.Array  # (K,3)
    X: jax.Array   # (L,3)


def _reproj_eval(data: VIBAData, state: VIBAState):
    def one(obs, kf, lm, cam):
        Twb = lie.se3_matrix(state.R[kf], state.p[kf])
        Xb = lie.transform_point(lie.se3_inv(Twb), state.X[lm])
        Tcb = lie.se3_inv(data.Tbc[cam])
        Xc = lie.transform_point(Tcb, Xb)
        r = obs - project_pinhole(data.K_intr[cam], Xc)
        pj = project_jac_pinhole(data.K_intr[cam], Xc)
        Rcb = Tcb[:3, :3]
        # d r / d [dphi, dp, dv]: pose retraction here is R<-R exp(dphi),
        # p <- p + dp (NOT the SE3 right-retraction of the GP solver)
        # Xb = R^T (X - p):  dXb/dphi = hat(Xb) R^T R ... derive via chain:
        dXb_dphi = lie.hat(Xb)  # R <- R exp(phi): Xb' = exp(-phi) Xb
        dXb_dp = -state.R[kf].T
        J_pose = jnp.concatenate(
            [-pj @ Rcb @ dXb_dphi, -pj @ Rcb @ dXb_dp, jnp.zeros((2, 3), r.dtype)],
            axis=1,
        )  # (2,9)
        J_lm = -pj @ Rcb @ state.R[kf].T
        return r, J_pose, J_lm, Xc[2]

    return jax.vmap(one)(data.obs, data.obs_kf, data.obs_lm, data.obs_cam)


def _imu_eval(data: VIBAData, state: VIBAState):
    def one(pre, pair, bg_lin, ba_lin):
        i, j = pair[0], pair[1]
        si = InertialState(R=state.R[i], p=state.p[i], v=state.v[i])
        sj = InertialState(R=state.R[j], p=state.p[j], v=state.v[j])
        r, Ji, Jj, Jbg, Jba = imu_residual_jac(
            si, sj, state.bg[i], state.ba[i], pre, bg_lin, ba_lin, data.gravity
        )
        info = jnp.linalg.inv(
            pre.C[:9, :9] + 1e-10 * jnp.eye(9, dtype=r.dtype)
        )
        return r, Ji, Jj, Jbg, Jba, info

    return jax.vmap(one)(data.pre, data.imu_pairs, data.bg_lin, data.ba_lin)


def make_vi_ba_problem(data: VIBAData) -> LMProblem:
    """VI-BA with landmark Schur complement, scatter-free. Parameter layout
    per KF: [dphi,dp,dv,dbg,dba] (15); landmarks marginalized (3 each).

    Same device mapping as solver/ba.py: per-edge Hessian blocks reduce
    into per-structure segments with one-hot matmuls instead of
    scatter-adds; reprojection edges all share the per-keyframe structure
    (their 9-dof pose block), IMU/bias-walk factors are one segment each;
    the landmark system (Hll, bl, W) Schur-eliminates with batched 3x3
    closed-form inverses."""
    K = data.pose_fixed.shape[0]
    dtype = data.obs.dtype
    delta = jnp.asarray(data.huber_mono, dtype)
    act_obs = data.obs_valid
    pose_act = (~data.pose_fixed).astype(dtype)

    def sizes(state):
        return 15 * K, state.X.shape[0]

    def chi2(state: VIBAState):
        r, _, _, _ = _reproj_eval(data, state)
        r = jnp.where(act_obs[:, None], r, 0.0)
        s = jnp.sum(r * r, -1) * data.w
        rho0, _ = robust.huber_rho01(s, delta, True)
        c = jnp.sum(jnp.where(act_obs, rho0, 0.0))

        r_i, Ji, Jj, Jbg, Jba, info = _imu_eval(data, state)
        r_i = jnp.where(data.imu_valid[:, None], r_i, 0.0)
        c += jnp.sum(jnp.einsum("ei,eij,ej->e", r_i, info, r_i))

        # bias random walk between consecutive KFs of each IMU pair
        i_, j_ = data.imu_pairs[:, 0], data.imu_pairs[:, 1]
        db = jnp.concatenate(
            [state.bg[j_] - state.bg[i_], state.ba[j_] - state.ba[i_]], axis=1
        )
        db = jnp.where(data.imu_valid[:, None], db, 0.0)
        c += jnp.sum(jnp.einsum("ei,ij,ej->e", db, data.walk_info, db))
        return c

    P = 15 * K
    act_vec = jnp.repeat(pose_act, 15)  # (P,)

    def linearize(state: VIBAState):
        _, L = sizes(state)
        seg_H, seg_b, seg_cols = [], [], []

        def add_seg(Hs, bs, cols, w_):
            if w_ < 24:
                Hs = jnp.pad(Hs, ((0, 0), (0, 24 - w_), (0, 24 - w_)))
                bs = jnp.pad(bs, ((0, 0), (0, 24 - w_)))
                cols = jnp.pad(cols, ((0, 0), (0, 24 - w_)))
            seg_H.append(Hs)
            seg_b.append(bs)
            seg_cols.append(cols.astype(jnp.int32))

        # ===== reprojection edges =====
        r, Jp, Jl, _ = _reproj_eval(data, state)
        m = act_obs[:, None]
        r = jnp.where(m, r, 0.0)
        Jp = jnp.where(m[..., None], Jp, 0.0)
        Jl = jnp.where(m[..., None], Jl, 0.0)
        Jp = Jp * pose_act[data.obs_kf][:, None, None]
        s = jnp.sum(r * r, -1) * data.w
        _, rho1 = robust.huber_rho01(s, delta, True)
        wgt = jnp.where(act_obs, data.w * rho1, 0.0)
        Jp9 = Jp[:, :, :9]  # v/bg/ba columns of reprojection are zero
        JpW = Jp9 * wgt[:, None, None]
        # per-keyframe 9x9 pose blocks: one-hot segment reduction
        Hblk = jnp.sum(JpW[:, :, :, None] * Jp9[:, :, None, :], axis=1)  # (E,9,9)
        bblk = -jnp.sum(JpW * r[:, :, None], axis=1)  # (E,9)
        onehot = (data.obs_kf[None, :] == jnp.arange(K)[:, None]).astype(dtype)
        E_ = Hblk.shape[0]
        Hs = (onehot @ Hblk.reshape(E_, 81)).reshape(K, 9, 9)
        bs = onehot @ bblk
        colK = (15 * jnp.arange(K)[:, None] + jnp.arange(9)[None, :])
        add_seg(Hs, bs, colK, 9)
        # landmark coupling W (3,9) per edge -> (L,K) block grid
        JlW = Jl * wgt[:, None, None]  # (E,2,3)
        Wblk = jnp.sum(JlW[:, :, :, None] * Jp9[:, :, None, :], axis=1)  # (E,3,9)
        Wp = jax.ops.segment_sum(Wblk, data.obs_lm * K + data.obs_kf, L * K)
        Wt = jnp.pad(
            Wp.reshape(L, K, 3, 9), ((0, 0), (0, 0), (0, 0), (0, 6))
        ).transpose(0, 2, 1, 3).reshape(L, 3, P)
        Hll = jax.ops.segment_sum(
            jnp.sum(JlW[:, :, :, None] * Jl[:, :, None, :], axis=1),
            data.obs_lm, L,
        )
        bl = jax.ops.segment_sum(
            -jnp.sum(JlW * r[:, :, None], axis=1), data.obs_lm, L
        )

        # ===== IMU factors (one segment each) =====
        r_i, Ji, Jj, Jbg, Jba, info = _imu_eval(data, state)
        mi = data.imu_valid[:, None]
        r_i = jnp.where(mi, r_i, 0.0)
        Ji = jnp.where(mi[..., None], Ji, 0.0)
        Jj = jnp.where(mi[..., None], Jj, 0.0)
        Jbg = jnp.where(mi[..., None], Jbg, 0.0)
        Jba = jnp.where(mi[..., None], Jba, 0.0)
        i_, j_ = data.imu_pairs[:, 0], data.imu_pairs[:, 1]
        Ji = Ji * pose_act[i_][:, None, None]
        Jj = Jj * pose_act[j_][:, None, None]
        # bias columns belong to keyframe i: fixed keyframes must keep their
        # bg/ba untouched too (the dense path zeroed the full 15-dof block)
        Jbg = Jbg * pose_act[i_][:, None, None]
        Jba = Jba * pose_act[i_][:, None, None]
        Jfull = jnp.concatenate([Ji, Jbg, Jba, Jj], axis=2)  # (Ki,9,24)
        colsi = jnp.concatenate(
            [
                15 * i_[:, None] + jnp.arange(15)[None, :],
                15 * j_[:, None] + jnp.arange(9)[None, :],
            ],
            axis=1,
        )  # (Ki,24)
        JWi = jnp.einsum("eab,ebc->eac", info, Jfull)
        add_seg(
            jnp.einsum("eri,erj->eij", JWi, Jfull),
            -jnp.einsum("eri,er->ei", JWi, r_i),
            colsi, 24,
        )

        # ===== bias random walk (one segment each) =====
        db = jnp.concatenate(
            [state.bg[j_] - state.bg[i_], state.ba[j_] - state.ba[i_]], axis=1
        )
        db = jnp.where(mi, db, 0.0)
        Ki_ = db.shape[0]
        Jw = jnp.tile(
            jnp.concatenate([-jnp.eye(6, dtype=dtype), jnp.eye(6, dtype=dtype)], 1)[None],
            (Ki_, 1, 1),
        )
        Jw = jnp.where(mi[..., None], Jw, 0.0)
        # mask each 6-column half by its keyframe's activity so fixed
        # keyframes' biases see no random-walk pull either
        act_w = jnp.concatenate(
            [jnp.tile(pose_act[i_][:, None], (1, 6)),
             jnp.tile(pose_act[j_][:, None], (1, 6))], axis=1)
        Jw = Jw * act_w[:, None, :]
        colsw = jnp.concatenate(
            [
                15 * i_[:, None] + 9 + jnp.arange(6)[None, :],
                15 * j_[:, None] + 9 + jnp.arange(6)[None, :],
            ],
            axis=1,
        )
        JWw = jnp.einsum("ab,ebc->eac", data.walk_info, Jw)
        add_seg(
            jnp.einsum("eri,erj->eij", JWw, Jw),
            -jnp.einsum("eri,er->ei", JWw, db),
            colsw, 12,
        )

        # ===== unified Hpp/bp assembly (two dense contractions) =====
        H_all = jnp.concatenate(seg_H, axis=0)
        b_all = jnp.concatenate(seg_b, axis=0)
        cols_all = jnp.concatenate(seg_cols, axis=0)
        M = (cols_all[:, :, None] == jnp.arange(P, dtype=jnp.int32)).astype(dtype)
        A = jnp.einsum("sab,sbq->saq", H_all, M)
        Hpp = jnp.einsum("sap,saq->pq", M, A)
        bp = jnp.einsum("sa,sap->p", b_all, M)
        return Hpp, bp, Wt, Hll, bl

    def max_abs_diag(lin):
        Hpp, bp, Wt, Hll, bl = lin
        m1 = jnp.max(jnp.abs(jnp.diagonal(Hpp)) * act_vec)
        m2 = jnp.max(jnp.abs(jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(Hll)))
        return jnp.maximum(m1, m2)

    def solve(lin, lam):
        from .ba import _inv3x3

        Hpp, bp, Wt, Hll, bl = lin
        eye3 = jnp.eye(3, dtype=dtype)
        Hll_inv = _inv3x3(Hll + lam * eye3[None])
        Y = jnp.einsum("lab,lbp->lap", Hll_inv, Wt)
        Hs = (
            Hpp
            + jnp.eye(P, dtype=dtype) * (lam * act_vec + (1.0 - act_vec))[None, :]
            - jnp.einsum("lap,laq->pq", Y, Wt)
        )
        bs = bp - jnp.einsum("lap,la->p", Y, bl)
        Lc, lower = jax.scipy.linalg.cho_factor(Hs)
        dxp = jax.scipy.linalg.cho_solve((Lc, lower), bs)
        dxl = jnp.einsum("lab,lb->la", Hll_inv, bl - jnp.einsum("lap,p->la", Wt, dxp))
        dx = jnp.concatenate([dxp, dxl.reshape(-1)])
        dot_xx = dxp @ dxp + jnp.sum(dxl * dxl)
        dot_xb = dxp @ bp + jnp.sum(dxl * bl)
        return dx, dot_xx, dot_xb

    def retract(state: VIBAState, dx):
        P = 15 * K
        d = dx[:P].reshape(K, 15)
        dX = dx[P:].reshape(-1, 3)
        R = jax.vmap(lambda Ri, di: Ri @ lie.exp_so3(di))(state.R, d[:, :3])
        return VIBAState(
            R=R,
            p=state.p + d[:, 3:6],
            v=state.v + d[:, 6:9],
            bg=state.bg + d[:, 9:12],
            ba=state.ba + d[:, 12:15],
            X=state.X + dX,
        )

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def vi_ba(data: VIBAData, state: VIBAState, num_iterations=10, lambda_init=1e-2):
    problem = make_vi_ba_problem(data)
    return lm_optimize(problem, state, num_iterations, lambda_init=lambda_init)
