"""PCG roofline profile: break down the at-scale matrix-free solvers the
way the dense local-BA path was profiled.

Measures, for bench configs 5c (5000-KF Sim3 essential graph) and 5d
(2000-KF / 10k-pt global BA):

  * CG iteration count per LM iteration (via the while_loop counter),
  * wall time per LM iteration vs the forcing tolerance (inexact-Newton
    sensitivity) and vs the preconditioner choice,
  * per-CG-iteration time against a device-memory bandwidth roofline
    computed from the edge arrays each Schur-product touches.

Usage: python examples/profile_pcg.py  (on a GPU listed in PEAK_GBPS)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from amcslam_tpu.solver.ba import make_ba_problem_pcg
from amcslam_tpu.solver.sim3_opt import make_essential_graph_problem_pcg
from amcslam_tpu.utils.synthetic import make_essential_graph, make_local_ba_problem

DTYPE = jnp.float32
# Published device-memory bandwidth by jax device_kind, GB/s (NVIDIA H100
# SXM data sheet: 80 GB HBM3 at 3.35 TB/s). A device not listed is an error.
PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def peak_gbps() -> float:
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_GBPS:
        raise RuntimeError(f"no memory-bandwidth peak for device {kind!r}")
    return PEAK_GBPS[kind]


def time_fn(fn, *args, n=10, warm=3):
    out = jax.block_until_ready(fn(*args))
    for _ in range(warm):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n, out


def profile_global_ba(tols=(1e-2, 1e-3, 1e-4), iters_caps=(40, 100, 400)):
    print("=== config 5d: global BA 2000 KF / 10k pts (Schur PCG) ===")
    data, state0, _ = make_local_ba_problem(
        n_kf=2000, n_fixed=1, n_lm=10000, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=0, noise_px=0.5, seed=0, dtype=DTYPE,
    )
    data = data._replace(gp_huber=jnp.asarray(True))
    E_st = int(data.st_obs.shape[0])
    E_mg = int(data.mg_obs.shape[0])
    K = int(data.n_poses)
    L = int(state0.X.shape[0])
    print(f"K={K} L={L} stereo_edges={E_st} monoGP_edges={E_mg}")

    # --- bytes touched by ONE Schur product Sx (f32):
    # stereo edges: J3 (E,3,12), Jls (E,3,3), w (E), x gath/scat 2*(E,12)
    # landmark pass: Hll_inv (L,3,3), z (L,3) x2
    # pose pass: D12 (K,12,12) in precond, x/r/p vectors (K,12) ~small
    by_edges = E_st * (3 * 12 + 3 * 3 + 1 + 2 * 12) * 4
    by_lm = L * (9 + 3 + 3) * 4
    by_pose = K * (144 + 5 * 12) * 4
    total_gb = (by_edges + by_lm + by_pose) / 1e9
    roofline_ms = total_gb / peak_gbps() * 1e3
    print(f"Schur-product traffic ~{total_gb*1e3:.1f} MB "
          f"-> memory roofline {roofline_ms:.3f} ms/CG-iter")

    for tol in tols:
        for cap in iters_caps:
            problem = make_ba_problem_pcg(
                data, data.mg_valid, data.sg_valid, data.st_valid,
                pcg_iters=cap, pcg_tol=tol,
            )

            @jax.jit
            def one_iter(state, lam):
                lin = problem.linearize(state)
                dx, xx, xb = problem.solve(lin, lam)
                s2 = problem.retract(state, dx)
                return s2, problem.chi2(s2)

            lam = jnp.asarray(1e-3, DTYPE)
            dt, (_, chi) = time_fn(one_iter, state0, lam, n=5)
            print(f"tol={tol:g} cap={cap}: {dt*1e3:8.1f} ms/LM-iter "
                  f"chi2'={float(chi):.4g}")

    # CG iteration count at the bench setting (prints via AMCSLAM_PCG_DEBUG)
    print("re-run with AMCSLAM_PCG_DEBUG=1 to print CG iters per solve")


def profile_eg(tols=(1e-2, 1e-3, 1e-4)):
    print("=== config 5c: Sim3 essential graph 5000 KF (PCG) ===")
    data, state0, _ = make_essential_graph(n_kf=5000, n_loop=40, seed=0,
                                           dtype=DTYPE)
    E = int(data.pairs.shape[0])
    N = int(data.fixed.shape[0])
    print(f"N={N} E={E}")
    # one Hx: per edge J1/J2 (E,7,7) blocks applied twice + gather/scatter
    # (E,7) x4; per vertex D (N,7,7) + vectors
    gb = (E * (2 * 49 + 4 * 7) + N * (49 + 5 * 7)) * 4 / 1e9
    print(f"Hx traffic ~{gb*1e3:.1f} MB -> roofline {gb/peak_gbps()*1e3:.3f} "
          "ms/CG-iter")
    for tol in tols:
        problem = make_essential_graph_problem_pcg(data, pcg_iters=100,
                                                   pcg_tol=tol)

        @jax.jit
        def one_iter(state, lam):
            lin = problem.linearize(state)
            dx, xx, xb = problem.solve(lin, lam)
            s2 = problem.retract(state, dx)
            return s2, problem.chi2(s2)

        lam = jnp.asarray(1e-8, DTYPE)
        dt, (_, chi) = time_fn(one_iter, state0, lam, n=5)
        print(f"tol={tol:g}: {dt*1e3:8.1f} ms/LM-iter chi2'={float(chi):.4g}")


def profile_cost_split():
    """Forced-iteration cap sweep (tol=0, caps 20/80): the slope is the
    per-CG-iteration cost, the intercept the fixed part (linearize +
    preconditioner + RHS). These are the README 'PCG at-scale solver
    profile' numbers."""
    print("=== cost split (tol=0 forced caps) ===")
    data, state0, _ = make_essential_graph(n_kf=5000, n_loop=40, seed=0,
                                           dtype=DTYPE)
    for name, make, lam in (
        ("EG", lambda cap: make_essential_graph_problem_pcg(
            data, pcg_iters=cap, pcg_tol=0.0), 1e-8),
    ):
        ts = {}
        for cap in (20, 80):
            problem = make(cap)

            @jax.jit
            def one(state, lam):
                lin = problem.linearize(state)
                dx, _, _ = problem.solve(lin, lam)
                return jax.tree_util.tree_leaves(dx)[0]

            ts[cap], _ = time_fn(one, state0, jnp.asarray(lam, DTYPE), n=5)
        slope = (ts[80] - ts[20]) / 60
        print(f"{name}: per-CG-iter {slope*1e3:.3f} ms, "
              f"fixed {(ts[20]-20*slope)*1e3:.1f} ms")
    datab, stateb, _ = make_local_ba_problem(
        n_kf=2000, n_fixed=1, n_lm=10000, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=0, noise_px=0.5, seed=0, dtype=DTYPE)
    datab = datab._replace(gp_huber=jnp.asarray(True))
    ts = {}
    for cap in (20, 80):
        problem = make_ba_problem_pcg(
            datab, datab.mg_valid, datab.sg_valid, datab.st_valid,
            pcg_iters=cap, pcg_tol=0.0)

        @jax.jit
        def one(state, lam):
            lin = problem.linearize(state)
            dx, _, _ = problem.solve(lin, lam)
            return dx[0]

        ts[cap], _ = time_fn(one, stateb, jnp.asarray(1e-3, DTYPE), n=5)
    slope = (ts[80] - ts[20]) / 60
    print(f"BA: per-CG-iter {slope*1e3:.3f} ms, "
          f"fixed {(ts[20]-20*slope)*1e3:.1f} ms")


def profile_warm_start(n_chain=12, cap=40, tol=1e-3):
    """Round 5: does warm-starting CG from the previous LM iteration's
    solution help the late chained iterations where block-Jacobi stalls?
    Runs the bench-5d chained protocol cold (x0=0 every iteration, the
    bench/reference-equivalent configuration) vs warm (x0 = previous dx)
    at the same cap/tol and compares wall time and chi2 trajectory.
    The warm variant pays one extra Schur product per solve (initial
    residual b - S x0)."""
    print(f"=== warm-start chained protocol (cap={cap}, tol={tol:g}) ===")
    data, state0, _ = make_local_ba_problem(
        n_kf=2000, n_fixed=1, n_lm=10000, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=0, noise_px=0.5, seed=0, dtype=DTYPE)
    data = data._replace(gp_huber=jnp.asarray(True))
    problem = make_ba_problem_pcg(
        data, data.mg_valid, data.sg_valid, data.st_valid,
        pcg_iters=cap, pcg_tol=tol)
    lam = jnp.asarray(1e-3, DTYPE)

    @jax.jit
    def cold_iter(state):
        lin = problem.linearize(state)
        dx, _, _ = problem.solve(lin, lam)
        s2 = problem.retract(state, dx)
        return s2, problem.chi2(s2)

    @jax.jit
    def warm_iter(state, x0):
        lin = problem.linearize(state)
        dx, _, _ = problem.solve(lin, lam, x0=x0)
        s2 = problem.retract(state, dx)
        return s2, problem.chi2(s2), (dx[0], dx[1])

    def run_cold():
        s = state0
        chis = []
        for _ in range(n_chain):
            s, chi = cold_iter(s)
            chis.append(chi)
        jax.block_until_ready(chis[-1])
        return [float(c) for c in chis]

    def run_warm():
        s = state0
        x0 = (jnp.zeros((int(data.n_poses), 12), DTYPE),
              jnp.zeros((int(data.n_ext), 6), DTYPE))
        chis = []
        for _ in range(n_chain):
            s, chi, x0 = warm_iter(s, x0)
            chis.append(chi)
        jax.block_until_ready(chis[-1])
        return [float(c) for c in chis]

    chis_c = run_cold()  # compile+first
    chis_w = run_warm()
    t0 = time.time(); chis_c = run_cold(); t_c = time.time() - t0
    t0 = time.time(); chis_w = run_warm(); t_w = time.time() - t0
    print(f"cold: {t_c/n_chain*1e3:7.1f} ms/LM-iter chi2 chain "
          f"{[round(c,1) for c in chis_c[:4]]}... -> {chis_c[-1]:.4g}")
    print(f"warm: {t_w/n_chain*1e3:7.1f} ms/LM-iter chi2 chain "
          f"{[round(c,1) for c in chis_w[:4]]}... -> {chis_w[-1]:.4g}")
    rel = abs(chis_w[-1] - chis_c[-1]) / max(abs(chis_c[-1]), 1e-12)
    print(f"final chi2 relative difference: {rel:.2e}")


if __name__ == "__main__":
    import sys as _sys
    peak_gbps()  # fail before any work on a device with no listed peak
    if "--warm" in _sys.argv:
        print(f"device={jax.devices()[0]}")
        profile_warm_start()
        raise SystemExit
    print(f"device={jax.devices()[0]}")
    profile_eg()
    profile_global_ba()
    profile_cost_split()
    # for CG iteration counts run
    # JAX_PLATFORMS=cpu AMCSLAM_PCG_DEBUG=1 python examples/profile_pcg.py
    # (identical arithmetic, hardware-independent).
