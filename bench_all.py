"""Five-config benchmark suite (BASELINE.md "configs to implement" 1-5)
plus an on-chip f32-vs-f64 chi2 parity measurement.

Runs each config on the default device and prints one JSON row per metric,
then one summary line. The single-line benchmark stays in bench.py; this
file carries the full BASELINE coverage:

  1. pose-only reprojection BA  — full PoseGPOptimizationFromeLastFrame
     schedule (4 rounds x 10 LM iterations), ms per full solve
  2. local windowed BA + landmark Schur complement (no GP edges), ms/LM iter
  3. sparse-GP continuous-time BA (async multi-camera), ms/LM iter
     (the bench.py headline)
  4. visual-inertial BA with IMU preintegration factors, ms/LM iter
  5. Sim3 essential graph (500 KFs, ms/graph-iteration) and full-map BA
     (global BA budget), ms/LM iter

Parity: relative |chi2_f32(device) - chi2_f64(cpu)| / chi2_f64 on the
config-3 problem — the measured achievable f32 tolerance on real hardware.
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

from amcslam_tpu.solver.ba import global_ba, make_ba_problem  # noqa: E402
from amcslam_tpu.solver.pose_solver import pose_gp_optimize  # noqa: E402
from amcslam_tpu.solver.sim3_opt import (  # noqa: E402
    EssentialGraphData,
    Sim3Field,
    optimize_essential_graph,
)
from amcslam_tpu.utils.synthetic import (  # noqa: E402
    make_local_ba_problem,
    make_pose_problem,
)

RESULTS = []


def _timeit(fn, args, n_warm=3, n_iter=20):
    """Chained jitted-call timing (>=10 calls amortize dispatch latency)."""
    out = jax.block_until_ready(fn(*args))
    for _ in range(n_warm):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n_iter):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n_iter * 1e3, out


def record(metric, value, unit, note=""):
    row = {
        "metric": metric,
        "value": round(float(value), 5),
        "unit": unit,
        "note": note,
    }
    RESULTS.append(row)
    print(json.dumps(row))


def lm_iter_fn(problem):
    @jax.jit
    def step(state, lam):
        lin = problem.linearize(state)
        dx, _, _ = problem.solve(lin, lam)
        new_state = problem.retract(state, dx)
        return new_state, problem.chi2(new_state)

    return step


def bench_pose_only():
    data, state0, gt = make_pose_problem(
        n_mono=128, n_stereo=96, n_cams=6, seed=0, dtype=jnp.float32
    )
    out_m = jnp.zeros(data.mg_obs.shape[0], bool)
    out_s = jnp.zeros(data.st_obs.shape[0], bool)
    fn = jax.jit(pose_gp_optimize)
    ms, _ = _timeit(lambda s: fn(data, s, out_m, out_s), (state0,), n_iter=10)
    record(
        "pose_only_full_solve_ms", ms, "ms",
        note="4x10 LM schedule, 128 mono-GP + 96 stereo obs, f32",
    )


def bench_local_schur():
    # stereo-only rig: no GP-interpolated async edges -> classic local BA
    data, state0, _ = make_local_ba_problem(
        n_kf=50, n_fixed=1, n_lm=5000, n_cams=2, obs_per_lm=6,
        gpobs_per_lm=0, noise_px=0.5, seed=0, dtype=jnp.float32,
    )
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    step = lm_iter_fn(problem)
    ms, _ = _timeit(step, (state0, jnp.asarray(1.0, jnp.float32)))
    record(
        "local_schur_ba_ms_per_lm_iter_50kf_5kpts", ms, "ms",
        note="reprojection-only window (LocalBundleAdjustment analogue)",
    )


def bench_gp_ba():
    data, state0, _ = make_local_ba_problem(
        n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=2, noise_px=0.5, seed=0, dtype=jnp.float32,
    )
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    step = lm_iter_fn(problem)
    ms, (state1, chi_dev) = _timeit(step, (state0, jnp.asarray(1.0, jnp.float32)))
    record(
        "local_gpba_ms_per_lm_iter_50kf_5kpts", ms, "ms",
        note="bench.py headline: GP continuous-time async multi-camera",
    )
    return data, state0


def bench_parity(seed=0):
    """chi2 parity: identical problem evaluated f32 on the default device
    and f64 on the host CPU."""
    kw = dict(n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
              gpobs_per_lm=2, noise_px=0.5, seed=seed)
    d32, s32, _ = make_local_ba_problem(dtype=jnp.float32, **kw)
    p32 = make_ba_problem(d32, d32.mg_valid, d32.sg_valid, d32.st_valid)
    chi32 = float(jax.jit(p32.chi2)(s32))
    cpu = jax.devices("cpu")[0]
    d64, s64, _ = make_local_ba_problem(dtype=jnp.float64, **kw)
    d64 = jax.device_put(d64, cpu)
    s64 = jax.device_put(s64, cpu)
    p64 = make_ba_problem(d64, d64.mg_valid, d64.sg_valid, d64.st_valid)
    with jax.default_device(cpu):
        chi64 = float(jax.jit(p64.chi2)(s64))
    rel = abs(chi32 - chi64) / abs(chi64)
    record(
        "chi2_f32_device_vs_f64_cpu_rel", rel, "relative",
        note=f"chi2 f32={chi32:.6f} f64={chi64:.6f}; measured achievable "
             "f32 tolerance on hardware",
    )


def bench_vi_ba():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "t_imu", os.path.join(os.path.dirname(__file__), "tests", "test_imu.py")
    )
    t_imu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t_imu)
    from amcslam_tpu.ops import imu
    from amcslam_tpu.solver.vi_ba import VIBAData, VIBAState, make_vi_ba_problem

    F = jnp.float32
    rng = np.random.RandomState(3)
    n_kf, steps_per_kf, dt = 20, 40, 0.005
    acc, gyro, dts, Rs, ps, vs = t_imu.simulate_imu(steps_per_kf * (n_kf - 1), dt=dt)
    kf_idx = np.arange(n_kf) * steps_per_kf
    Nga = jnp.eye(6, dtype=F) * 1e-6
    walk = jnp.eye(6, dtype=F) * 1e-8
    pres = []
    for k in range(n_kf - 1):
        sl = slice(k * steps_per_kf, (k + 1) * steps_per_kf)
        pres.append(imu.preintegrate(
            jnp.asarray(acc[sl], F), jnp.asarray(gyro[sl], F),
            jnp.asarray(dts[sl], F), jnp.zeros(3, F), jnp.zeros(3, F),
            Nga, walk,
        ))
    pre_b = jax.tree.map(lambda *xs: jnp.stack(xs), *pres)

    from amcslam_tpu.utils.synthetic import make_rig
    Tbc, Kin, bf = make_rig(2, 4)
    n_lm = 500
    X = rng.randn(n_lm, 3) * 3 + np.array([2.0, 0.0, 8.0])
    obs, okf, olm, ocam = [], [], [], []
    for k in range(n_kf):
        R, p = Rs[kf_idx[k]], ps[kf_idx[k]]
        Twb = np.eye(4); Twb[:3, :3] = R; Twb[:3, 3] = p
        Twc = Twb @ Tbc[0]
        Xc = (np.linalg.inv(Twc)[:3, :3] @ X.T).T + np.linalg.inv(Twc)[:3, 3]
        vis = Xc[:, 2] > 1.0
        for l in np.where(vis)[0]:
            u = Kin[0, 0] * Xc[l, 0] / Xc[l, 2] + Kin[0, 2] + rng.randn() * 0.3
            v_ = Kin[0, 1] * Xc[l, 1] / Xc[l, 2] + Kin[0, 3] + rng.randn() * 0.3
            obs.append([u, v_]); okf.append(k); olm.append(l); ocam.append(0)
    E = len(obs)
    G = np.array([0, 0, -9.81])
    data = VIBAData(
        pre=jax.tree.map(lambda a: a.astype(F) if a.dtype.kind == "f" else a, pre_b),
        imu_pairs=jnp.asarray(np.stack([np.arange(n_kf - 1), np.arange(1, n_kf)], 1), jnp.int32),
        imu_valid=jnp.ones(n_kf - 1, bool),
        bg_lin=jnp.zeros((n_kf - 1, 3), F),
        ba_lin=jnp.zeros((n_kf - 1, 3), F),
        walk_info=jnp.eye(6, dtype=F) * 1e4,
        gravity=jnp.asarray(G, F),
        obs=jnp.asarray(np.array(obs), F),
        obs_kf=jnp.asarray(okf, jnp.int32),
        obs_lm=jnp.asarray(olm, jnp.int32),
        obs_cam=jnp.asarray(ocam, jnp.int32),
        w=jnp.ones(E, F),
        obs_valid=jnp.ones(E, bool),
        Tbc=jnp.asarray(Tbc, F),
        K_intr=jnp.asarray(Kin, F),
        pose_fixed=jnp.asarray(np.arange(n_kf) == 0),
    )
    state = VIBAState(
        R=jnp.asarray(Rs[kf_idx], F),
        p=jnp.asarray(ps[kf_idx], F),
        v=jnp.asarray(vs[kf_idx], F),
        bg=jnp.zeros((n_kf, 3), F),
        ba=jnp.zeros((n_kf, 3), F),
        X=jnp.asarray(X + rng.randn(n_lm, 3) * 0.05, F),
    )
    problem = make_vi_ba_problem(data)
    step = lm_iter_fn(problem)
    ms, _ = _timeit(step, (state, jnp.asarray(1.0, F)))
    record(
        "vi_ba_ms_per_lm_iter_20kf_500pts", ms, "ms",
        note=f"{E} reprojections + 19 IMU preintegration factors, f32",
    )


def bench_sim3_graph():
    rng = np.random.RandomState(5)
    N = 500
    F = jnp.float32
    step = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / N])
    from amcslam_tpu.ops import lie
    est = [np.eye(4)]
    for k in range(1, N):
        noise = np.concatenate([rng.randn(3) * 0.02, rng.randn(3) * 0.005])
        est.append(est[-1] @ np.asarray(lie.exp_se3(jnp.asarray(step + noise))))
    pairs, meas = [], []
    for k in range(N - 1):
        pairs.append((k, k + 1))
        meas.append(np.linalg.inv(est[k + 1]) @ est[k])
    pairs.append((N - 1, 0))
    meas.append(np.eye(4))
    E = len(pairs)
    data = EssentialGraphData(
        pairs=jnp.asarray(np.array(pairs), jnp.int32),
        meas_s=jnp.ones(E, F),
        meas_R=jnp.asarray(np.stack([M[:3, :3] for M in meas]), F),
        meas_t=jnp.asarray(np.stack([M[:3, 3] for M in meas]), F),
        valid=jnp.ones(E, bool),
        fixed=jnp.asarray(np.arange(N) == 0),
        fix_scale=jnp.asarray(True),
    )
    state = Sim3Field(
        s=jnp.ones(N, F),
        R=jnp.asarray(np.stack([np.linalg.inv(e)[:3, :3] for e in est]), F),
        t=jnp.asarray(np.stack([np.linalg.inv(e)[:3, 3] for e in est]), F),
    )
    fn = jax.jit(lambda s_: optimize_essential_graph(data, s_))
    ms, _ = _timeit(lambda s_: fn(s_), (state,), n_iter=5)
    record(
        "essential_graph_500kf_full_opt_ms", ms, "ms",
        note="20 graph iterations, lambda=1e-16 (Optimizer.cc:1447)",
    )

    # full-map BA at the global-BA budget on the 50 KF / 5k pt problem
    data_g, state_g, _ = make_local_ba_problem(
        n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=2, noise_px=0.5, seed=1, dtype=jnp.float32,
    )
    data_g = data_g._replace(gp_huber=jnp.asarray(True))
    fn_g = jax.jit(lambda d, s: global_ba(d, s, 10))
    ms_g, _ = _timeit(lambda s: fn_g(data_g, s), (state_g,), n_iter=3)
    record(
        "global_ba_full_10iter_ms_50kf_5kpts", ms_g, "ms",
        note="RunGlobalBundleAdjustment budget (LoopClosing.cc:1221)",
    )


def main():
    dev = jax.devices()[0]
    print(f"# device: {dev}", file=sys.stderr)
    for fn in [bench_pose_only, bench_local_schur, bench_gp_ba, bench_parity,
               bench_vi_ba, bench_sim3_graph]:
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # keep the suite going; record the failure
            record(fn.__name__ + "_FAILED", -1, "error", note=repr(e)[:300])
        print(f"# {fn.__name__}: {time.time() - t0:.1f}s total",
              file=sys.stderr)
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "results": RESULTS}))


if __name__ == "__main__":
    main()
