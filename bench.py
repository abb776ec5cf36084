"""Benchmarks for all five BASELINE.md configs + on-device f32 parity.

Headline: local GP bundle adjustment ms per LM iteration at 50 KF / 5k
points on one GPU. One LM
iteration = one linearization (all residuals + analytic Jacobians), the
landmark Schur complement, the damped reduced Cholesky solve, landmark
back-substitution, manifold retraction, and the re-evaluated robust chi2 —
i.e. one full accepted trial of `OptimizationAlgorithmLevenberg::solve`
(g2o/core/optimization_algorithm_levenberg.cpp:61-166).

Also timed (BASELINE.md "configs to implement"):
  1. pose-only per-frame solve (PoseOptimization / 4x10 LM schedule,
     Optimizer.cc:550-562) — full solve latency
  2. local windowed BA with landmark Schur, no GP-interpolated edges
  3. sparse-GP continuous-time BA (= headline)
  4. visual-inertial BA with IMU preintegration factors (landmark Schur)
  5. Sim3 essential-graph pose graph + full/global BA per LM iteration

Parity: the SAME optimized f32 state's chi2 is re-evaluated in f64 on the
CPU backend of a subprocess; the relative difference is reported as
`parity.chi2_rel_f32_vs_f64`.

Prints ONE JSON line: the headline {"metric", "value", "unit", "device"}
plus "configs" and "parity" sub-dicts. Runs only on a GPU; BENCH_SMOKE=1
shrinks every problem for a functional check on any backend.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from amcslam_tpu.solver.ba import make_ba_problem, make_ba_problem_pcg  # noqa: E402
from amcslam_tpu.solver.pose_solver import pose_gp_optimize  # noqa: E402
from amcslam_tpu.solver.sim3_opt import (  # noqa: E402
    make_essential_graph_problem,
    make_essential_graph_problem_pcg,
    optimize_essential_graph,
)
from amcslam_tpu.solver.vi_ba import make_vi_ba_problem  # noqa: E402
from amcslam_tpu.utils.synthetic import (  # noqa: E402
    make_essential_graph,
    make_local_ba_problem,
    make_pose_problem,
    make_vi_ba_synthetic,
)

DTYPE = jnp.float32
# BENCH_SMOKE=1 shrinks every problem for a fast functional check (CPU ok)
SMOKE = os.environ.get("BENCH_SMOKE", "") == "1"

# The driver runs bench.py under an external `timeout` (round 4 hit it:
# rc=124, no JSON emitted). Two defenses:
#   * an internal deadline — before each non-headline config we check the
#     remaining budget against that config's estimated cold cost and skip
#     (recording which were skipped) rather than get killed mid-compile;
#   * a SIGTERM handler that prints the best-so-far JSON line and exits,
#     so even an external kill yields a parsed result once the headline
#     config has landed.
# With the persistent compile cache warm (same repo, unchanged solver HLO)
# the whole bench runs in ~1 min and nothing is ever skipped.
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "450"))
T_START = time.time()
RESULT: dict = {}


def _emit():
    print(json.dumps(RESULT), flush=True)


def _on_sigterm(sig, frame):
    """Emit the best-so-far line if the headline landed; a kill before that
    is a failed run and exits non-zero."""
    if RESULT.get("value") is not None:
        RESULT["terminated_early"] = True
        _emit()
        sys.exit(0)
    sys.exit(1)


signal.signal(signal.SIGTERM, _on_sigterm)


def _budget(name, est_s):
    """True if `est_s` (cold-compile cost estimate) fits the remaining
    deadline budget; otherwise record the skip and return False."""
    left = DEADLINE_S - (time.time() - T_START)
    if left < est_s:
        _log(f"SKIP {name}: {left:.0f}s budget left < {est_s:.0f}s estimate")
        RESULT.setdefault("skipped_configs", []).append(name)
        return False
    return True


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


N_REPEAT = 2 if SMOKE else 5  # median-of-N timing blocks


def _median_band(samples):
    """(median, [min, max]) of per-block ms samples, rounded for the JSON."""
    med = float(np.median(samples))
    return med, [round(float(min(samples)), 4), round(float(max(samples)), 4)]


def time_lm_iteration(problem, state0, n_warm=3, n_iter=20, lam=1.0):
    """Steady-state ms per chained LM iteration (linearize+solve+retract+chi2).

    Runs N_REPEAT independently-timed blocks of `n_iter` chained iterations
    and reports the MEDIAN block (with the min..max band): a robust location
    estimate against host-side timing noise.
    Returns (ms_median, band, end_state)."""

    @jax.jit
    def lm_iteration(state, lam):
        lin = problem.linearize(state)
        dx, dot_xx, dot_xb = problem.solve(lin, lam)
        new_state = problem.retract(state, dx)
        chi = problem.chi2(new_state)
        return new_state, chi

    lam = jnp.asarray(lam, DTYPE)
    t0 = time.time()
    s, chi = jax.block_until_ready(lm_iteration(state0, lam))
    _log(f"  compile+first: {time.time() - t0:.1f}s chi2={float(chi):.1f}")
    s = state0
    for _ in range(n_warm):
        s, chi = lm_iteration(s, lam)
    jax.block_until_ready((s, chi))
    samples = []
    for _ in range(N_REPEAT):
        s = state0
        t0 = time.time()
        for _ in range(n_iter):
            s, chi = lm_iteration(s, lam)
        jax.block_until_ready((s, chi))
        samples.append((time.time() - t0) / n_iter * 1e3)
    ms, band = _median_band(samples)
    _log(f"  blocks: {[round(x, 3) for x in samples]} -> median {ms:.3f}")
    return ms, band, s


def bench_pose_only():
    """Config 1: full per-frame pose solve (4 rounds x 10 LM iterations)."""
    nm, ns = (32, 24) if SMOKE else (192, 128)
    data, state0, _ = make_pose_problem(
        n_mono=nm, n_stereo=ns, n_cams=6, noise_px=0.5, seed=0, dtype=DTYPE
    )
    om = jnp.zeros(data.mg_obs.shape[0], bool)
    os_ = jnp.zeros(data.st_obs.shape[0], bool)
    solve = jax.jit(pose_gp_optimize)
    t0 = time.time()
    jax.block_until_ready(solve(data, state0, om, os_))
    _log(f"  compile+first: {time.time() - t0:.1f}s")
    for _ in range(3):
        out = solve(data, state0, om, os_)
    jax.block_until_ready(out)
    n = 20
    samples = []
    for _ in range(N_REPEAT):
        t0 = time.time()
        for _ in range(n):
            out = solve(data, state0, om, os_)
        jax.block_until_ready(out)
        samples.append((time.time() - t0) / n * 1e3)
    return _median_band(samples)


def bench_local_ba(gpobs_per_lm, tag):
    kf, lm = (8, 64) if SMOKE else (50, 5000)
    data, state0, _ = make_local_ba_problem(
        n_kf=kf, n_fixed=1, n_lm=lm, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=gpobs_per_lm, noise_px=0.5, seed=0, dtype=DTYPE,
    )
    _log(
        f"{tag}: K={data.n_poses} L={state0.X.shape[0]} "
        f"mono-GP={data.mg_obs.shape[0]} stereo={data.st_obs.shape[0]}"
    )
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    ms, band, s_out = time_lm_iteration(problem, state0)
    return ms, band, data, s_out


def bench_vi_ba():
    kf, lm = (5, 48) if SMOKE else (20, 500)
    data, state0, _ = make_vi_ba_synthetic(n_kf=kf, n_lm=lm, seed=0, dtype=DTYPE)
    _log(f"vi_ba: K={kf} L={lm} E={data.obs.shape[0]}")
    problem = make_vi_ba_problem(data)
    ms, band, _ = time_lm_iteration(problem, state0, lam=1.0)
    return ms, band

def bench_essential_graph():
    kf, nl = (40, 5) if SMOKE else (500, 40)
    data, state0, _ = make_essential_graph(n_kf=kf, n_loop=nl, seed=0, dtype=DTYPE)
    _log(f"sim3_graph: N={kf} E={data.pairs.shape[0]}")
    problem = make_essential_graph_problem(data)
    ms, band, _ = time_lm_iteration(problem, state0, lam=1e-8)
    return ms, band


def bench_essential_graph_5k():
    """Config 5c: at-scale Sim3 pose graph (matrix-free block-Jacobi PCG —
    the LinearSolverEigen sparse-Cholesky capability, Optimizer.cc:1442)."""
    kf, nl = (64, 3) if SMOKE else (5000, 40)
    data, state0, _ = make_essential_graph(n_kf=kf, n_loop=nl, seed=0, dtype=DTYPE)
    _log(f"sim3_graph_5k: N={kf} E={data.pairs.shape[0]} (PCG)")
    # inexact-Newton forcing tolerance: LM accept/reject guards correctness,
    # so the inner CG only needs enough accuracy to produce a descent step
    # (measured: chi2 after 6 LM iters within 0.01% of tol=1e-6)
    problem = make_essential_graph_problem_pcg(data, pcg_iters=100, pcg_tol=1e-3)
    ms, band, _ = time_lm_iteration(problem, state0, lam=1e-8, n_iter=5)
    return ms, band


def bench_10km_ate():
    """Config 5e: the at-scale north star — a 10 km / 4-lap drifted
    trajectory (2000 KF at 5 m spacing) with revisit loop closures, solved
    by the PCG essential graph; reports TUM-style aligned ATE as a percent
    of path length (reference contract: <= 0.5%)."""
    kf, laps, step = (64, 2, 5.0) if SMOKE else (2000, 4, 5.0)
    data, state0, Ts_gt = make_essential_graph(
        n_kf=kf, n_loop=60, drift=0.002, seed=4, dtype=DTYPE,
        step_m=step, laps=laps)
    path_len = kf * step
    _log(f"sim3_graph_10km: N={kf} E={data.pairs.shape[0]} "
         f"path={path_len/1000:.1f} km (PCG)")
    out, _ = jax.jit(
        lambda s: optimize_essential_graph(data, s, use_pcg=True)
    )(state0)
    jax.block_until_ready(out.t)

    def centers(field):
        s = np.asarray(field.s)[:, None]
        R = np.asarray(field.R)
        t = np.asarray(field.t)
        return -np.einsum("kij,kj->ki", R.transpose(0, 2, 1), t) / s

    def ate(p, g):
        mp_, mg = p.mean(0), g.mean(0)
        U, _, Vt = np.linalg.svd((g - mg).T @ (p - mp_))
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        Ra = U @ D @ Vt
        e = (p @ Ra.T + (mg - Ra @ mp_)) - g
        return float(np.sqrt((e**2).sum(1).mean()))

    pg = Ts_gt[:, :3, 3]
    a0 = ate(centers(state0), pg)
    a1 = ate(centers(out), pg)
    _log(f"  aligned ATE {a0:.2f} -> {a1:.2f} m")
    return 100.0 * a1 / path_len


def bench_global_ba_pcg():
    """Config 5d: at-scale global BA (2000 KF / 10k pts) with the matrix-free
    Schur PCG backend — the dense reduced system would be 24k x 24k."""
    kf, lm = (8, 64) if SMOKE else (2000, 10000)
    data, state0, _ = make_local_ba_problem(
        n_kf=kf, n_fixed=1, n_lm=lm, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=0, noise_px=0.5, seed=0, dtype=DTYPE,
    )
    data = data._replace(gp_huber=jnp.asarray(True))
    _log(
        f"global_ba_pcg: K={data.n_poses} L={state0.X.shape[0]} "
        f"stereo={data.st_obs.shape[0]} (PCG)"
    )
    problem = make_ba_problem_pcg(
        data, data.mg_valid, data.sg_valid, data.st_valid,
        # inexact-Newton forcing (see 5c note); cap=40 because block-Jacobi
        # stalls at rel_res ~0.5 on late chained iterations and the extra
        # iterations buy nothing: cap-40 vs cap-100 chained chi2 agree to
        # ~6e-4 relative over 12 iterations (README "PCG at-scale profile")
        pcg_iters=40, pcg_tol=1e-3,
    )
    ms, band, _ = time_lm_iteration(problem, state0, lam=1e-3, n_iter=5)
    return ms, band


def parity_f64(state_f32):
    """Re-evaluate the optimized f32 state's chi2 in f64 on CPU (subprocess
    with x64 + cpu platform; same seed regenerates bit-identical f64 data)."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state.npz")
        np.savez(
            path,
            **{k: np.asarray(v, np.float64) for k, v in state_f32._asdict().items()},
        )
        kf, lm = (8, 64) if SMOKE else (50, 5000)
        code = f"""
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from amcslam_tpu.solver.ba import BAState, make_ba_problem
from amcslam_tpu.utils.synthetic import make_local_ba_problem
data, _, _ = make_local_ba_problem(n_kf={kf}, n_fixed=1, n_lm={lm}, n_cams=6,
    obs_per_lm=4, gpobs_per_lm=2, noise_px=0.5, seed=0, dtype=jnp.float64)
z = np.load({path!r})
state = BAState(**{{k: jnp.asarray(z[k], jnp.float64) for k in z.files}})
p = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
print("CHI2_F64", repr(float(p.chi2(state))))
"""
        # JAX_PLATFORMS=cpu keeps the child off the GPU: the parent process
        # already holds the card's memory
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=900,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        for line in out.stdout.splitlines():
            if line.startswith("CHI2_F64"):
                return float(line.split()[1])
        _log(f"parity subprocess failed: {out.stderr[-500:]}")
        return None


def main():
    dev = jax.devices()[0]
    _log(f"device={dev}")
    if dev.platform != "gpu" and not SMOKE:
        _log(f"no GPU (platform {dev.platform!r}); set BENCH_SMOKE=1 for a "
             "functional run on another backend")
        sys.exit(1)

    results = {}
    RESULT.update(
        {
            "metric": "local_gpba_ms_per_lm_iter_50kf_5kpts",
            "value": None,
            "unit": "ms",
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "n_repeat": N_REPEAT,
            "configs": results,
            "parity": {"chi2_rel_f32_vs_f64": None},
        }
    )

    _log("config 3: sparse-GP continuous-time local BA (headline)")
    headline_ms, headline_band, data3, s3 = bench_local_ba(
        gpobs_per_lm=2, tag="gp_local_ba")
    results["gp_local_ba_ms_per_iter"] = round(headline_ms, 4)
    results["gp_local_ba_ms_band"] = headline_band
    RESULT["value"] = round(headline_ms, 4)
    RESULT["band"] = headline_band
    _log(f"  {headline_ms:.3f} ms/iter (band {headline_band})")

    if _budget("pose_only", 60):
        _log("config 1: pose-only per-frame solve (4x10)")
        ms1, band1 = bench_pose_only()
        results["pose_only_ms_per_solve"] = round(ms1, 4)
        results["pose_only_ms_band"] = band1
        _log(f"  {ms1:.3f} ms/solve (band {band1})")

    if _budget("schur_ba", 30):
        _log("config 2: local Schur BA (no GP edges)")
        ms2, band2, _, _ = bench_local_ba(gpobs_per_lm=0, tag="schur_ba")
        results["schur_ba_ms_per_iter"] = round(ms2, 4)
        results["schur_ba_ms_band"] = band2
        _log(f"  {ms2:.3f} ms/iter (band {band2})")

    if _budget("vi_ba", 35):
        _log("config 4: visual-inertial BA (IMU preintegration)")
        ms4, band4 = bench_vi_ba()
        results["vi_ba_ms_per_iter"] = round(ms4, 4)
        results["vi_ba_ms_band"] = band4
        _log(f"  {ms4:.3f} ms/iter (band {band4})")

    if _budget("sim3_graph", 55):
        _log("config 5a: Sim3 essential graph, 500 KF")
        ms5, band5 = bench_essential_graph()
        results["sim3_graph_ms_per_iter"] = round(ms5, 4)
        results["sim3_graph_ms_band"] = band5
        _log(f"  {ms5:.3f} ms/iter (band {band5})")

    if _budget("sim3_graph_5k", 25):
        _log("config 5c: Sim3 essential graph at 5000 KF (PCG)")
        ms5c, band5c = bench_essential_graph_5k()
        results["sim3_graph_5k_ms_per_iter"] = round(ms5c, 4)
        results["sim3_graph_5k_ms_band"] = band5c
        _log(f"  {ms5c:.3f} ms/iter (band {band5c})")

    if _budget("sim3_graph_10km", 60):
        _log("config 5e: 10 km / 4-lap pose graph, aligned ATE after PCG closure")
        results["sim3_graph_10km_ate_pct"] = round(bench_10km_ate(), 4)
        _log(f"  {results['sim3_graph_10km_ate_pct']:.4f}% of path "
             "(contract: <=0.5%)")

    if _budget("global_ba_pcg_2k", 30):
        _log("config 5d: global BA at 2000 KF / 10k pts (Schur PCG)")
        ms5d, band5d = bench_global_ba_pcg()
        results["global_ba_pcg_2k_ms_per_iter"] = round(ms5d, 4)
        results["global_ba_pcg_2k_ms_band"] = band5d
        _log(f"  {ms5d:.3f} ms/iter (band {band5d})")

    if _budget("global_ba", 35):
        _log("config 5b: global BA (Huber GP chain) per iter")
        data_g = data3._replace(gp_huber=jnp.asarray(True))
        problem_g = make_ba_problem(
            data_g, data_g.mg_valid, data_g.sg_valid, data_g.st_valid,
            huber_on=True,
        )
        ms_g, band_g, _ = time_lm_iteration(problem_g, s3)
        results["global_ba_ms_per_iter"] = round(ms_g, 4)
        results["global_ba_ms_band"] = band_g
        _log(f"  {ms_g:.3f} ms/iter (band {band_g})")

    # parity: same state, f32-on-device vs f64-on-CPU chi2 (subprocess with
    # jax cpu+x64; runs last so a tight budget skips it rather than a config)
    if _budget("parity_f64", 90):
        problem3 = make_ba_problem(
            data3, data3.mg_valid, data3.sg_valid, data3.st_valid)
        chi_f32 = float(jax.jit(problem3.chi2)(s3))
        chi_f64 = parity_f64(s3)
        if chi_f64:
            RESULT["parity"] = {
                "chi2_f32": chi_f32,
                "chi2_f64": chi_f64,
                "chi2_rel_f32_vs_f64": round(
                    abs(chi_f32 - chi_f64) / abs(chi_f64), 9),
            }
        _log(f"parity: {RESULT['parity']}")

    _log(f"total wall {time.time() - T_START:.0f}s "
         f"(deadline {DEADLINE_S:.0f}s)")
    _emit()


if __name__ == "__main__":
    main()
