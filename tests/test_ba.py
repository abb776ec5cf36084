"""Local GP-BA tests: Schur complement vs dense solve, convergence,
divergence guard, and outlier erasure masks."""

import jax
import jax.numpy as jnp
import numpy as np

from amcslam_tpu.solver.ba import (
    BAState,
    LocalBAData,
    local_gp_ba,
    make_ba_problem,
)
from amcslam_tpu.solver.lm import lm_optimize
from amcslam_tpu.utils.synthetic import make_local_ba_problem

F64 = jnp.float64


def small_problem(**kw):
    kw.setdefault("n_kf", 6)
    kw.setdefault("n_fixed", 1)
    kw.setdefault("n_lm", 48)
    kw.setdefault("obs_per_lm", 3)
    kw.setdefault("seed", 0)
    return make_local_ba_problem(**kw)


def test_schur_complement_matches_dense_solve():
    """The Schur-complement solve must equal the dense joint solve of the
    full (poses+extrinsics+landmarks) damped normal equations."""
    data, state0, gt = small_problem()
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    lin = problem.linearize(state0)
    Hpp, bp, Wt, Hll, bl = [np.asarray(x) for x in lin]
    P = Hpp.shape[0]
    L = Hll.shape[0]
    K = data.n_poses
    Cx = data.n_ext

    lam = 0.37
    (dxp, dxl), dot_xx, dot_xb = problem.solve(lin, jnp.asarray(lam, F64))

    # dense assembly (extrinsics live in 12-wide phantom column groups;
    # phantom columns are inactive -> identity rows, dx = 0 there)
    phantom = np.tile(np.r_[np.ones(6), np.zeros(6)], Cx)
    act = np.concatenate(
        [
            np.repeat(~np.asarray(data.pose_fixed), 12).astype(float),
            np.repeat(~np.asarray(data.ext_fixed), 12).astype(float) * phantom,
        ]
    )
    N = P + 3 * L
    H = np.zeros((N, N))
    H[:P, :P] = Hpp + np.diag(lam * act + (1 - act))
    for l in range(L):
        H[P + 3 * l : P + 3 * l + 3, :P] = Wt[l]
        H[:P, P + 3 * l : P + 3 * l + 3] = Wt[l].T
        H[P + 3 * l : P + 3 * l + 3, P + 3 * l : P + 3 * l + 3] = (
            Hll[l] + lam * np.eye(3)
        )
    b = np.concatenate([bp, bl.ravel()])
    dx = np.linalg.solve(H, b)
    np.testing.assert_allclose(np.asarray(dxp), dx[:P], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(dxl).ravel(), dx[P:], rtol=1e-7, atol=1e-9
    )
    np.testing.assert_allclose(float(dot_xx), dx @ dx, rtol=1e-8)
    np.testing.assert_allclose(float(dot_xb), dx @ b, rtol=1e-8)


def test_ba_converges_to_ground_truth():
    data, state0, gt = small_problem(noise_px=0.0)
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    chi0 = float(problem.chi2(state0))
    state, stats = jax.jit(lambda s: lm_optimize(problem, s, 15, lambda_init=1.0))(
        state0
    )
    chi1 = float(stats.chi2)
    # noise-free: residuals -> ~0 except the vertical-velocity regularizer
    vz = np.asarray(gt.v[:, 2])
    floor = float(np.sum(vz[np.asarray(~data.pose_fixed)] ** 2)) * 1.2 + 1e-3
    assert chi1 < min(0.05 * chi0, floor + 0.2 * chi0), (chi0, chi1, floor)
    # free poses move toward ground truth
    free = np.asarray(~data.pose_fixed)
    T_err0 = np.abs(np.asarray(state0.T)[free] - np.asarray(gt.T)[free]).max()
    T_err1 = np.abs(np.asarray(state.T)[free] - np.asarray(gt.T)[free]).max()
    assert T_err1 < 0.2 * T_err0, (T_err0, T_err1)


def test_local_gp_ba_wrapper_and_outliers():
    data, state0, gt = small_problem(noise_px=0.5, seed=2)
    res = jax.jit(lambda d, s: local_gp_ba(d, s))(data, state0)
    assert bool(res.ok)
    assert float(res.err_final) < float(res.err_initial)
    # clean data: very few erasures
    n_erase = int(jnp.sum(res.erase_m)) + int(jnp.sum(res.erase_st))
    n_total = int(jnp.sum(data.mg_valid)) + int(jnp.sum(data.st_valid))
    assert n_erase < 0.05 * n_total, (n_erase, n_total)


def test_local_gp_ba_divergence_guard_nan():
    """NaN observations must trip the guard and leave the state untouched."""
    data, state0, gt = small_problem(seed=3)
    bad = data._replace(
        st_obs=data.st_obs.at[0].set(jnp.asarray([np.nan, np.nan, np.nan], F64))
    )
    res = local_gp_ba(bad, state0)
    assert not bool(res.ok)
    np.testing.assert_array_equal(np.asarray(res.state.T), np.asarray(state0.T))


def test_gather_tables_match_segment_sum_fallback():
    """The landmark-major gather assembly (table-driven path) must produce the
    same (Hpp, bp, Wt, Hll, bl) as the segment-sum fallback."""
    data, state0, gt = small_problem(seed=5)
    assert data.lm_blk is not None
    data_fb = data._replace(
        lm_blk=None, lm_blk_g=None, lm_blk_valid=None,
        lm_edge=None, lm_edge_valid=None,
    )
    p_fast = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    p_fb = make_ba_problem(data_fb, data.mg_valid, data.sg_valid, data.st_valid)
    lin_fast = p_fast.linearize(state0)
    lin_fb = p_fb.linearize(state0)
    for a, b, name in zip(lin_fast, lin_fb, ["Hpp", "bp", "Wt", "Hll", "bl"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12, err_msg=name
        )


def test_ba_f32_stability():
    """The BA pipeline runs in float32 (the on-device production dtype) without NaNs
    and still reduces chi2 by >10x."""
    data, state0, gt = small_problem(noise_px=0.2, seed=4, dtype=jnp.float32)
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    chi0 = float(problem.chi2(state0))
    state, stats = lm_optimize(problem, state0, 10, lambda_init=1.0)
    chi1 = float(stats.chi2)
    assert np.isfinite(chi1) and chi1 < 0.1 * chi0, (chi0, chi1)


def test_pcg_backend_matches_dense_schur():
    """The matrix-free PCG BA backend (make_ba_problem_pcg) must converge to
    the same optimum as the dense Schur path on the same problem — the
    at-scale replacement for LinearSolverEigen (Optimizer.cc:70)."""
    from amcslam_tpu.solver.ba import make_ba_problem_pcg

    data, state0, gt = small_problem(noise_px=0.4, seed=5)
    lvl = (data.mg_valid, data.sg_valid, data.st_valid)
    dense = make_ba_problem(data, *lvl, huber_on=True)
    pcg = make_ba_problem_pcg(data, *lvl, huber_on=True)

    s_d, st_d = jax.jit(lambda s: lm_optimize(dense, s, 10, lambda_init=1e-5))(state0)
    s_p, st_p = jax.jit(lambda s: lm_optimize(pcg, s, 10, lambda_init=1e-5))(state0)
    c_d, c_p = float(st_d.chi2), float(st_p.chi2)
    assert abs(c_p - c_d) <= 1e-6 * max(c_d, 1.0), (c_d, c_p)
    np.testing.assert_allclose(np.asarray(s_p.T), np.asarray(s_d.T), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_p.X), np.asarray(s_d.X), atol=1e-4)


def test_pcg_single_solve_matches_dense_solve():
    """One damped solve: PCG dx vs dense Schur dx on identical
    linearizations (direct linear-algebra agreement, not just same optimum)."""
    from amcslam_tpu.solver.ba import make_ba_problem_pcg

    data, state0, gt = small_problem(noise_px=0.3, seed=7)
    lvl = (data.mg_valid, data.sg_valid, data.st_valid)
    dense = make_ba_problem(data, *lvl, huber_on=True)
    pcg = make_ba_problem_pcg(data, *lvl, huber_on=True, pcg_iters=400,
                              pcg_tol=1e-16)
    lam = jnp.asarray(1e-3, F64)
    dx_d, xx_d, xb_d = dense.solve(dense.linearize(state0), lam)
    dx_p, xx_p, xb_p = pcg.solve(pcg.linearize(state0), lam)
    dxp_d, dxl_d = dx_d
    x12_p, xe_p, dxl_p = dx_p
    K = data.n_poses
    np.testing.assert_allclose(
        np.asarray(dxp_d[: 12 * K]).reshape(K, 12), np.asarray(x12_p),
        atol=1e-7,
    )
    np.testing.assert_allclose(np.asarray(dxl_d), np.asarray(dxl_p), atol=1e-7)
    np.testing.assert_allclose(float(xx_p), float(xx_d), rtol=1e-6)
    np.testing.assert_allclose(float(xb_p), float(xb_d), rtol=1e-6)


def test_pcg_schur_jacobi_precond_matches_dense_solve():
    """The optional SCHUR_JACOBI preconditioner (block diagonal of S itself)
    must not change the solution — only the CG iteration count. Kept as a
    tested option; plain block-Jacobi is the default."""
    from amcslam_tpu.solver.ba import make_ba_problem_pcg

    data, state0, gt = small_problem(noise_px=0.3, seed=7)
    lvl = (data.mg_valid, data.sg_valid, data.st_valid)
    dense = make_ba_problem(data, *lvl, huber_on=True)
    pcg = make_ba_problem_pcg(data, *lvl, huber_on=True, pcg_iters=400,
                              pcg_tol=1e-16, precond="schur_jacobi")
    lam = jnp.asarray(1e-3, F64)
    dx_d, xx_d, xb_d = dense.solve(dense.linearize(state0), lam)
    dx_p, xx_p, xb_p = pcg.solve(pcg.linearize(state0), lam)
    dxp_d, dxl_d = dx_d
    x12_p, xe_p, dxl_p = dx_p
    K = data.n_poses
    np.testing.assert_allclose(
        np.asarray(dxp_d[: 12 * K]).reshape(K, 12), np.asarray(x12_p),
        atol=1e-7,
    )
    np.testing.assert_allclose(np.asarray(dxl_d), np.asarray(dxl_p), atol=1e-7)


def test_extrinsic_phase2_recovers_perturbed_text():
    """LocalGPBA phase 2 (b_extrinsic, Optimizer.cc:1227-1240): with
    observations generated under the TRUE extrinsic and the state's Text
    perturbed, the second optimization phase pulls the extrinsic back
    toward truth (solver-level isolation of VERDICT r2 item 3)."""
    from amcslam_tpu.ops import lie
    from amcslam_tpu.ops.host_geom import log_se3

    data, state0, gt = make_local_ba_problem(
        n_kf=8, n_fixed=1, n_lm=200, n_cams=3, obs_per_lm=4,
        gpobs_per_lm=2, noise_px=0.3, seed=0, dtype=F64,
    )
    pert = np.asarray(
        lie.exp_se3(jnp.asarray([0.02, -0.015, 0.01, 0.008, -0.006, 0.01], F64))
    )
    Text0 = np.asarray(state0.Text).copy()
    Text_p = Text0.copy()
    Text_p[0] = Text_p[0] @ pert
    s0 = state0._replace(Text=jnp.asarray(Text_p, F64))
    res = jax.jit(
        lambda d, s: local_gp_ba(d, s, b_extrinsic=True, ext_min_obs=10)
    )(data, s0)
    assert bool(res.ok)

    def ext_err(T):
        return np.linalg.norm(log_se3(np.linalg.inv(Text0[0]) @ np.asarray(T)))

    e0 = ext_err(Text_p[0])
    e1 = ext_err(np.asarray(res.state.Text)[0])
    assert e1 < 0.3 * e0, (e0, e1)


def test_stereo_camera_mono_gp_edges():
    """A GPObs on the stereo camera with no right match is a plain mono-GP
    edge whose cam index equals n_ext — the virtual stereo row
    (Optimizer.cc:281-303 consumes EdgeMonoGP for *any* camera; extrinsic
    vertices exist only for async cameras, Optimizer.cc:983-996). The edge
    must produce finite residuals through the stereo Tbc/K and must never
    move the (non-existent) stereo extrinsic vertex."""
    from amcslam_tpu.solver.ba import _mono_gp_residuals, with_landmark_tables

    data, state0, gt = small_problem(n_lm=64, gpobs_per_lm=1, seed=11)
    Cx = data.n_ext
    mgv = np.asarray(data.mg_valid)
    idx = np.where(mgv)[0][::5]
    cam2 = np.asarray(data.mg_cam).copy()
    cam2[idx] = Cx  # retarget to the stereo camera
    d2 = data._replace(mg_cam=jnp.asarray(cam2))
    # consistent observations at ground truth (residual with obs=0 = -proj)
    proj = -np.asarray(
        _mono_gp_residuals(d2._replace(mg_obs=jnp.zeros_like(d2.mg_obs)), gt)
    )
    ok = np.isfinite(proj).all(1) & (np.abs(proj) < 5000).all(1)
    obs = np.asarray(data.mg_obs).copy()
    obs[idx] = proj[idx]
    valid2 = mgv.copy()
    valid2[idx] &= ok[idx]
    assert valid2[idx].sum() > 5
    d2 = d2._replace(mg_obs=jnp.asarray(obs), mg_valid=jnp.asarray(valid2))
    d2 = with_landmark_tables(d2, int(np.asarray(gt.X).shape[0]))

    problem = make_ba_problem(d2, d2.mg_valid, d2.sg_valid, d2.st_valid)
    chi0 = float(problem.chi2(state0))
    assert np.isfinite(chi0)
    Text_before = np.asarray(state0.Text).copy()
    res = jax.jit(
        lambda s: local_gp_ba(d2, s, b_extrinsic=True, ext_min_obs=1)
    )(state0)
    assert bool(res.ok)
    assert np.isfinite(float(res.err_final))
    assert float(res.err_final) < chi0
    assert np.isfinite(np.asarray(res.state.T)).all()
    # the stereo camera has no extrinsic vertex: Text keeps its (Cx,) shape
    assert np.asarray(res.state.Text).shape == Text_before.shape
