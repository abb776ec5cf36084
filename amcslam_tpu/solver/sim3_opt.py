"""Sim(3) optimizers for loop closure.

  * optimize_sim3 — bidirectional multi-camera Sim3 refinement between two
    keyframes (`Optimizer::OptimizeSim3`, Optimizer.cc:2049-2362): one Sim3
    vertex, fixed landmark pairs expressed in each KF's camera frames, paired
    forward/inverse reprojection edges with Huber delta = sqrt(th2);
    optimize(5) -> chi2 pair-prune -> optimize(10 if any pruned else 5) ->
    inlier count.
  * optimize_essential_graph — Sim3 pose graph over all keyframes
    (`Optimizer::OptimizeEssentialGraph`, Optimizer.cc:1434-1717): vertices
    S_cw with left-multiplicative retraction, EdgeSim3 residuals
    log(C S1 S2^-1) with identity 7x7 information, LM lambda_0 = 1e-16,
    20 iterations; loop keyframe fixed.

The reference uses numeric Jacobians for all Sim3 edges (linearizeOplus
commented out, OptimizableTypes.h:194,222; EdgeSim3 has none) — here they
are exact `jax.jacfwd` of the residual wrt the left retraction, vmapped over
edges; XLA fuses the forward+tangent evaluation into one batched kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..factors.reprojection import project_pinhole
from ..ops import lie, sim3
from ..ops.sim3 import Sim3
from . import robust
from .ba import _sorted_segment
from .lm import LMProblem, lm_optimize

# Env-gated PCG convergence tracing (iteration count + relative residual).
import os as _os

_PCG_DEBUG = _os.environ.get("AMCSLAM_PCG_DEBUG", "") == "1"


# ---------------------------------------------------------------------------
# OptimizeSim3
# ---------------------------------------------------------------------------


class Sim3PairData(NamedTuple):
    """Paired forward/inverse Sim3 reprojection edges (padded SoA)."""

    X1: jax.Array      # (N,3) points in KF1 camera frame (camera cam1)
    X2: jax.Array      # (N,3) points in KF2 camera frame (camera cam2)
    obs1: jax.Array    # (N,2) observation in KF1 (image of cam1)
    obs2: jax.Array    # (N,2) observation in KF2
    cam1: jax.Array    # (N,) int32
    cam2: jax.Array    # (N,) int32
    w1: jax.Array      # (N,) invSigma2 of obs1
    w2: jax.Array      # (N,)
    valid: jax.Array   # (N,) bool
    K1: jax.Array      # (C1,4) intrinsics of KF1 cameras
    K2: jax.Array      # (C2,4)
    Tc1b: jax.Array    # (C1,4,4) camera-from-body, KF1
    Tc2b: jax.Array    # (C2,4,4)
    fix_scale: jax.Array  # () bool


def _sim3_pair_residuals(S12: Sim3, data: Sim3PairData):
    """(r12 (N,2), r21 (N,2)): forward and inverse reprojection residuals.

    r12 = obs1 - pi_c1(Tc1b[cam1] . S12 . Tc2b[cam2]^-1 . X2)
    r21 = obs2 - pi_c2(Tc2b[cam2] . S12^-1 . Tc1b[cam1]^-1 . X1)
    (OptimizableTypes.h:185-191, 212-219)
    """

    def fwd(X2, obs1, c1, c2):
        Xb2 = lie.transform_point(lie.se3_inv(data.Tc2b[c2]), X2)
        Xb1 = sim3.act(S12, Xb2)
        Xc1 = lie.transform_point(data.Tc1b[c1], Xb1)
        return obs1 - project_pinhole(data.K1[c1], Xc1)

    def inv_(X1, obs2, c1, c2):
        Xb1 = lie.transform_point(lie.se3_inv(data.Tc1b[c1]), X1)
        Xb2 = sim3.act(sim3.inv(S12), Xb1)
        Xc2 = lie.transform_point(data.Tc2b[c2], Xb2)
        return obs2 - project_pinhole(data.K2[c2], Xc2)

    r12 = jax.vmap(fwd)(data.X2, data.obs1, data.cam1, data.cam2)
    r21 = jax.vmap(inv_)(data.X1, data.obs2, data.cam1, data.cam2)
    return r12, r21


def _make_sim3_problem(data: Sim3PairData, lvl12, lvl21, delta) -> LMProblem:
    dtype = data.X1.dtype
    act12 = data.valid & lvl12
    act21 = data.valid & lvl21

    def residuals_of(S12: Sim3):
        return _sim3_pair_residuals(S12, data)

    def chi2(S12: Sim3):
        r12, r21 = residuals_of(S12)
        s12 = jnp.sum(r12 * r12, -1) * data.w1
        s21 = jnp.sum(r21 * r21, -1) * data.w2
        rho12, _ = robust.huber_rho01(s12, delta, True)
        rho21, _ = robust.huber_rho01(s21, delta, True)
        return jnp.sum(jnp.where(act12, rho12, 0.0)) + jnp.sum(
            jnp.where(act21, rho21, 0.0)
        )

    def linearize(S12: Sim3):
        def r_of_delta(d):
            S = sim3.retract_left(S12, d, data.fix_scale)
            return _sim3_pair_residuals(S, data)

        (r12, r21) = r_of_delta(jnp.zeros(7, dtype))
        (J12, J21) = jax.jacfwd(r_of_delta)(jnp.zeros(7, dtype))

        m12 = act12[:, None]
        m21 = act21[:, None]
        r12 = jnp.where(m12, r12, 0.0)
        r21 = jnp.where(m21, r21, 0.0)
        J12 = jnp.where(m12[..., None], J12, 0.0)
        J21 = jnp.where(m21[..., None], J21, 0.0)

        s12 = jnp.sum(r12 * r12, -1) * data.w1
        s21 = jnp.sum(r21 * r21, -1) * data.w2
        _, rho12 = robust.huber_rho01(s12, delta, True)
        _, rho21 = robust.huber_rho01(s21, delta, True)
        w12 = jnp.where(act12, data.w1 * rho12, 0.0)
        w21 = jnp.where(act21, data.w2 * rho21, 0.0)

        H = jnp.einsum("eri,e,erj->ij", J12, w12, J12) + jnp.einsum(
            "eri,e,erj->ij", J21, w21, J21
        )
        b = -jnp.einsum("eri,e,er->i", J12, w12, r12) - jnp.einsum(
            "eri,e,er->i", J21, w21, r21
        )
        return H, b

    def max_abs_diag(lin):
        return jnp.max(jnp.abs(jnp.diagonal(lin[0])))

    def solve(lin, lam):
        H, b = lin
        dx = jnp.linalg.solve(H + lam * jnp.eye(7, dtype=dtype), b)
        return dx, dx @ dx, dx @ b

    def retract(S12: Sim3, dx):
        return sim3.retract_left(S12, dx, data.fix_scale)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def optimize_sim3(data: Sim3PairData, S12: Sim3, th2: float = 10.0):
    """Full OptimizeSim3 schedule. Returns (S12', n_inliers, inlier_mask)."""
    dtype = data.X1.dtype
    delta = jnp.asarray(np.sqrt(th2), dtype)
    lvl = jnp.ones_like(data.valid)

    problem = _make_sim3_problem(data, lvl, lvl, delta)
    S12, _ = lm_optimize(problem, S12, 5)

    # pair-prune: either side over th2 kills both edges (Optimizer.cc:2293-2320)
    r12, r21 = _sim3_pair_residuals(S12, data)
    s12 = jnp.sum(r12 * r12, -1) * data.w1
    s21 = jnp.sum(r21 * r21, -1) * data.w2
    bad = (s12 > th2) | (s21 > th2)
    lvl2 = data.valid & ~bad
    n_bad = jnp.sum(bad & data.valid)
    n_more = jnp.where(n_bad > 0, 10, 5)

    problem2 = _make_sim3_problem(data, lvl2, lvl2, delta)
    S12, _ = lm_optimize(problem2, S12, n_more)

    r12, r21 = _sim3_pair_residuals(S12, data)
    s12 = jnp.sum(r12 * r12, -1) * data.w1
    s21 = jnp.sum(r21 * r21, -1) * data.w2
    inlier = lvl2 & (s12 < th2) & (s21 < th2)
    return S12, jnp.sum(inlier), inlier


# ---------------------------------------------------------------------------
# OptimizeEssentialGraph
# ---------------------------------------------------------------------------


class EssentialGraphData(NamedTuple):
    """Sim3 pose graph (padded SoA)."""

    pairs: jax.Array     # (E,2) int32 (i,j): edge residual log(C S_i S_j^-1)
    meas_s: jax.Array    # (E,)
    meas_R: jax.Array    # (E,3,3)
    meas_t: jax.Array    # (E,3)
    valid: jax.Array     # (E,) bool
    fixed: jax.Array     # (N,) bool — the loop keyframe
    fix_scale: jax.Array  # () bool


class Sim3Field(NamedTuple):
    """N Sim3 vertices as SoA."""

    s: jax.Array  # (N,)
    R: jax.Array  # (N,3,3)
    t: jax.Array  # (N,3)


def _eg_residuals(state: Sim3Field, data: EssentialGraphData):
    """All edge residuals (E,7)."""

    def one(pair, ms, mR, mt):
        i, j = pair[0], pair[1]
        Si = Sim3(state.s[i], state.R[i], state.t[i])
        Sj = Sim3(state.s[j], state.R[j], state.t[j])
        return sim3.sim3_error(Sim3(ms, mR, mt), Si, Sj)

    return jax.vmap(one)(data.pairs, data.meas_s, data.meas_R, data.meas_t)


def _eg_residual_jacs(state: Sim3Field, data: EssentialGraphData):
    """(r (E,7), J (E,7,14)): per-edge residual + Jacobian wrt the left
    retractions of both endpoint vertices (exact autodiff, vmapped)."""
    dtype = state.t.dtype

    def one(pair, ms, mR, mt):
        i, j = pair[0], pair[1]

        def f(d):
            Si = sim3.retract_left(
                Sim3(state.s[i], state.R[i], state.t[i]), d[:7], data.fix_scale
            )
            Sj = sim3.retract_left(
                Sim3(state.s[j], state.R[j], state.t[j]), d[7:], data.fix_scale
            )
            return sim3.sim3_error(Sim3(ms, mR, mt), Si, Sj)

        z = jnp.zeros(14, dtype)
        return f(z), jax.jacfwd(f)(z)

    return jax.vmap(one)(data.pairs, data.meas_s, data.meas_R, data.meas_t)


def make_essential_graph_problem(data: EssentialGraphData) -> LMProblem:
    def chi2(state: Sim3Field):
        r = _eg_residuals(state, data)
        r = jnp.where(data.valid[:, None], r, 0.0)
        return jnp.sum(r * r)

    def linearize(state: Sim3Field):
        N = state.s.shape[0]
        dtype = state.t.dtype
        r, J = _eg_residual_jacs(state, data)

        i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
        act = (~data.fixed).astype(dtype)
        m = data.valid[:, None]
        r = jnp.where(m, r, 0.0)
        J = jnp.where(m[..., None], J, 0.0)
        J = J.at[:, :, :7].multiply(act[i_][:, None, None])
        J = J.at[:, :, 7:].multiply(act[j_][:, None, None])
        cols = jnp.concatenate(
            [
                7 * i_[:, None] + jnp.arange(7)[None, :],
                7 * j_[:, None] + jnp.arange(7)[None, :],
            ],
            axis=1,
        )
        Hblk = jnp.einsum("eri,erj->eij", J, J)
        bblk = -jnp.einsum("eri,er->ei", J, r)
        H = jnp.zeros((7 * N, 7 * N), dtype)
        b = jnp.zeros((7 * N,), dtype)
        H = H.at[cols[:, :, None], cols[:, None, :]].add(Hblk)
        b = b.at[cols].add(bblk)
        act_vec = jnp.repeat(act, 7)
        return H, b, act_vec

    def max_abs_diag(lin):
        H, b, act_vec = lin
        return jnp.max(jnp.abs(jnp.diagonal(H)) * act_vec)

    def solve(lin, lam):
        H, b, act_vec = lin
        Hd = H + jnp.diag(lam * act_vec + (1.0 - act_vec))
        Lc, lower = jax.scipy.linalg.cho_factor(Hd)
        dx = jax.scipy.linalg.cho_solve((Lc, lower), b)
        return dx, dx @ dx, dx @ b

    def retract(state: Sim3Field, dx):
        N = state.s.shape[0]
        d = dx.reshape(N, 7)

        def one(s, R, t, di):
            S = sim3.retract_left(Sim3(s, R, t), di, data.fix_scale)
            return S.s, S.R, S.t

        s, R, t = jax.vmap(one)(state.s, state.R, state.t, d)
        return Sim3Field(s=s, R=R, t=t)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def make_essential_graph_problem_pcg(
    data: EssentialGraphData, pcg_iters: int = 250, pcg_tol: float = 1e-10
) -> LMProblem:
    """Matrix-free essential graph for at-scale pose graphs (the rebuild of
    LinearSolverEigen's sparse Cholesky, Optimizer.cc:1442-1444, as a
    batched iterative solver): the 7Nx7N normal matrix is never formed —
    H.x products evaluate edge-wise as J_e^T (J_e x[cols_e]) with two
    segment-sums, preconditioned by the inverted per-vertex 7x7 block
    diagonal (block-Jacobi). Memory is O(E) instead of O(N^2); a 5k-KF graph
    fits where the dense Cholesky would need a 35k x 35k matrix."""

    def chi2(state: Sim3Field):
        r = _eg_residuals(state, data)
        r = jnp.where(data.valid[:, None], r, 0.0)
        return jnp.sum(r * r)

    seg_i = _sorted_segment(data.pairs[:, 0])
    seg_j = _sorted_segment(data.pairs[:, 1])

    def linearize(state: Sim3Field):
        dtype = state.t.dtype
        r, J = _eg_residual_jacs(state, data)
        i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
        act = (~data.fixed).astype(dtype)
        m = data.valid[:, None]
        r = jnp.where(m, r, 0.0)
        J = jnp.where(m[..., None], J, 0.0)
        Ji = J[:, :, :7] * act[i_][:, None, None]
        Jj = J[:, :, 7:] * act[j_][:, None, None]
        N = state.s.shape[0]
        # block-Jacobi preconditioner blocks + gradient
        Di = seg_i(jnp.einsum("eri,erj->eij", Ji, Ji), N)
        Dj = seg_j(jnp.einsum("eri,erj->eij", Jj, Jj), N)
        D = Di + Dj
        bi = seg_i(-jnp.einsum("eri,er->ei", Ji, r), N)
        bj = seg_j(-jnp.einsum("eri,er->ei", Jj, r), N)
        b = bi + bj
        return Ji, Jj, i_, j_, D, b, act

    def max_abs_diag(lin):
        *_, D, b, act = lin
        diag = jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(D)
        return jnp.max(jnp.abs(diag) * act[:, None])

    def solve(lin, lam):
        Ji, Jj, i_, j_, D, b, act = lin
        dtype = b.dtype
        N = b.shape[0]
        eye7 = jnp.eye(7, dtype=dtype)
        # damped preconditioner; fixed vertices get identity (their b is 0)
        Dd = D + (lam * act + (1.0 - act))[:, None, None] * eye7[None]
        Minv = jnp.linalg.inv(Dd)

        def Hx(x):  # x: (N,7)
            u = jnp.einsum("erc,ec->er", Ji, x[i_]) + jnp.einsum(
                "erc,ec->er", Jj, x[j_]
            )
            out = seg_i(
                jnp.einsum("erc,er->ec", Ji, u), N
            ) + seg_j(jnp.einsum("erc,er->ec", Jj, u), N)
            return out + (lam * act + (1.0 - act))[:, None] * x

        def dot(a, c):
            return jnp.sum(a * c)

        x0 = jnp.zeros_like(b)
        r0 = b  # b - H @ 0
        z0 = jnp.einsum("nij,nj->ni", Minv, r0)
        p0 = z0
        rz0 = dot(r0, z0)
        bnorm = jnp.maximum(dot(b, b), jnp.asarray(1e-30, dtype))

        def body(c):
            x, rr, z, p, rz, it = c
            Hp = Hx(p)
            alpha = rz / jnp.maximum(dot(p, Hp), jnp.asarray(1e-30, dtype))
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = jnp.einsum("nij,nj->ni", Minv, rr)
            rz_new = dot(rr, z)
            beta = rz_new / jnp.maximum(rz, jnp.asarray(1e-30, dtype))
            p = z + beta * p
            return x, rr, z, p, rz_new, it + 1

        def cond(c):
            x, rr, _, _, _, it = c
            return (it < pcg_iters) & (dot(rr, rr) > pcg_tol * bnorm)

        x, rr_f, _, _, _, it_f = jax.lax.while_loop(
            cond, body, (x0, r0, z0, p0, rz0, 0)
        )
        if _PCG_DEBUG:
            jax.debug.print(
                "eg-pcg iters={it} rel_res={rr:.3e}",
                it=it_f, rr=dot(rr_f, rr_f) / bnorm,
            )
        dx = x.reshape(-1)
        return dx, dx @ dx, dx @ b.reshape(-1)

    def retract(state: Sim3Field, dx):
        N = state.s.shape[0]
        d = dx.reshape(N, 7)

        def one(s, R, t, di):
            S = sim3.retract_left(Sim3(s, R, t), di, data.fix_scale)
            return S.s, S.R, S.t

        s, R, t = jax.vmap(one)(state.s, state.R, state.t, d)
        return Sim3Field(s=s, R=R, t=t)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def optimize_essential_graph(
    data: EssentialGraphData, state: Sim3Field, use_pcg: bool = False
):
    """20 LM iterations, lambda_0 = 1e-16 (Optimizer.cc:1442-1447, 1665).
    `use_pcg` switches to the matrix-free block-Jacobi PCG backend for
    at-scale graphs (the reference's sparse-Cholesky capability)."""
    problem = (
        make_essential_graph_problem_pcg(data)
        if use_pcg
        else make_essential_graph_problem(data)
    )
    return lm_optimize(problem, state, 20, lambda_init=1e-16)
