"""Smoke test of the SLAM stack on one GPU, through its normal entry points.

    python chip_smoke.py           # one GPU: gate, solvers, pipeline
    python chip_smoke.py --four    # four GPUs: the sharded solvers only

Phases (one process; any failure exits non-zero and prints no result line):

  gate      the default JAX device is a GPU; prints the card's name and power
            limit (nvidia-smi), the matmul precision, and requires both
            native C++ extensions to build (no silent NumPy fallback).
  solvers   float32 on the card at the bench shapes (bench.py): local GP-BA
            at 50 KF / 5k points (chi2 re-evaluated in float64 on the CPU),
            the 4x10 pose solve (against the float64 CPU solve of the same
            problem), the 5000-KF essential graph and the 2000-KF / 10k-point
            global BA through PCG (finite, decreasing chi2).
  pipeline  the on-device ORB extractor against the host one on a rig tick,
            then examples/e2e_rendered.run -> System.track_multicamera on the
            AMV rig (5 async cameras + stereo, 960x600, 10 fps) and on the
            rendered loop course, with the test suite's tracking/ATE bounds.

`--four` runs only the sharded local BA (parallel/sharded_ba.py, 50 KF / 5k
points) and the sharded essential graph (parallel/sharded_eg.py, 5000 KF) on a
flat 4-device mesh, each against the one-device solve of the same problem.

The float64 reference runs in a child process with JAX_PLATFORMS=cpu, so only
this process opens the card. The last line of standard output, on success
only, is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "examples"))

# --- tolerances, each with its reason -------------------------------------
# Local GP-BA chi2 of one state, f32 on the card vs f64 on the CPU: f32
# roundoff summed over ~40k residuals at HIGHEST matmul precision (the TF32
# path would sit near 1e-3).
LOCAL_BA_CHI2_RTOL = 1e-5
# 4x10 pose solve, f32 card vs f64 CPU: both stop at g2o's relative-chi2
# criterion, so the poses agree to the solve's convergence, not to roundoff.
POSE_T_TOL_M = 1e-4
POSE_R_TOL_RAD = 1e-5
POSE_INLIER_TOL = 2          # edges at the chi2 gate may flip class in f32
# On-device ORB vs host ORB on one rig tick (the two select keypoints by
# different policies: quadtree vs cell-best + top-K, see orb_device.py).
ORB_COUNT_RTOL = 0.2         # valid keypoints per image within 20 %
ORB_COLOCATED_MIN = 0.5      # share of host keypoints found within 1.5 px
ORB_HAMMING_MEDIAN_MAX = 8   # same BRIEF pattern and blur: near bit-equal
# Tracking/ATE bounds of tests/test_e2e_scenarios.py and test_loop_e2e.py.
RIG_ATE_FRAC = 0.005
LOOP_ATE_FRAC = 0.01
# Sharded vs one-device solves in f32: the same arithmetic summed in another
# order (psum of shards, atomic scatters), so equal to roundoff at the start
# and to LM-trajectory drift after several iterations.
SHARD_CHI2_RTOL_INIT = 1e-5
SHARD_BA_CHI2_RTOL = 1e-4
SHARD_EG_CHI2_RTOL = 1e-3    # inexact PCG (tol 1e-3) amplifies the drift
SHARD_MEM_RATIO_MAX = 1.5    # live array bytes per device, largest/smallest

# --- problem shapes (bench.py) --------------------------------------------
LOCAL_BA = dict(n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
                gpobs_per_lm=2, noise_px=0.5, seed=0)
POSE = dict(n_mono=192, n_stereo=128, n_cams=6, noise_px=0.5, seed=0)
EG = dict(n_kf=5000, n_loop=40, seed=0)
GBA = dict(n_kf=2000, n_fixed=1, n_lm=10000, n_cams=6, obs_per_lm=4,
           gpobs_per_lm=0, noise_px=0.5, seed=0)
RIG_RUN = dict(n_frames=40, fps=10.0, seed=1, n_async=5, n_features=800,
               device_render=True, size=(960, 600))
LOOP_RUN = dict(n_frames=70, fps=5.0, seed=0, circle=True, circle_period=12.0,
                circle_radius=4.0, n_features=500)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    print(f"  {'PASS' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


class CompileClock:
    """Sums JAX's trace + lower + backend-compile durations (seconds)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event in self.EVENTS:
            self.total += duration


class Phase:
    def __init__(self, name, clock):
        self.name, self.clock = name, clock

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0, self.c0 = time.time(), self.clock.total
        return self

    def __exit__(self, *exc):
        print(f"   {self.name}: wall {time.time() - self.t0:.1f} s, "
              f"compile {self.clock.total - self.c0:.1f} s", flush=True)


# --- gate -------------------------------------------------------------------
def gate(need_native=True):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    print(f"device: platform={d0.platform} kind={d0.device_kind} "
          f"count={len(devs)}", flush=True)
    if d0.platform != "gpu":
        raise SmokeFailure(f"no GPU: default device platform is {d0.platform!r}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    for line in out.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)

    import amcslam_tpu  # noqa: F401  (sets the package-wide precision)

    print(f"jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    if need_native:
        from amcslam_tpu import native

        check(native.available("orb_fast"), "native ORB extension builds")
        check(native.available(), "native graph-builder extension builds")
    return d0


# --- float64 CPU reference (child process) --------------------------------
def oracle(in_path: str):
    """Child mode: JAX_PLATFORMS=cpu, x64. Re-evaluates the local-BA chi2 of
    the card's final state and solves the pose problem in f64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from amcslam_tpu.solver.ba import BAState, make_ba_problem
    from amcslam_tpu.solver.pose_solver import pose_gp_optimize
    from amcslam_tpu.utils.synthetic import make_local_ba_problem, make_pose_problem

    assert jax.devices()[0].platform == "cpu"
    z = np.load(in_path)
    cfg = json.loads(str(z["cfg"]))
    data, _, _ = make_local_ba_problem(dtype=jnp.float64, **cfg["local_ba"])
    state = BAState(**{k: jnp.asarray(z["ba_" + k], jnp.float64)
                       for k in BAState._fields})
    p = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    chi2 = float(jax.jit(p.chi2)(state))

    pdata, pstate0, _ = make_pose_problem(dtype=jnp.float64, **cfg["pose"])
    om = jnp.zeros(pdata.mg_obs.shape[0], bool)
    os_ = jnp.zeros(pdata.st_obs.shape[0], bool)
    ps, lm_, ls_, (_, n_in) = jax.jit(pose_gp_optimize)(pdata, pstate0, om, os_)
    print("ORACLE " + json.dumps({
        "local_ba_chi2": chi2,
        "pose_T": np.asarray(ps.T).tolist(),
        "pose_inliers": int(n_in),
    }), flush=True)


def start_oracle(ba_state, tmpdir):
    path = os.path.join(tmpdir, "oracle_in.npz")
    cfg = {"local_ba": LOCAL_BA, "pose": POSE}
    np.savez(path, cfg=json.dumps(cfg),
             **{"ba_" + k: np.asarray(v, np.float64)
                for k, v in ba_state._asdict().items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--oracle", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=HERE)


def finish_oracle(proc, timeout=900):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure("f64 CPU reference timed out")
    for line in out.splitlines():
        if line.startswith("ORACLE "):
            return json.loads(line[len("ORACLE "):])
    raise SmokeFailure(f"f64 CPU reference failed: {err[-2000:]}")


def _rot_angle(Ra, Rb):
    """Angle of Ra^T Rb; atan2 form, accurate for tiny angles (arccos of
    the trace is not)."""
    D = Ra.T @ Rb
    s = 0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                              D[1, 0] - D[0, 1]])
    return float(np.arctan2(s, (np.trace(D) - 1.0) / 2.0))


# --- solvers ----------------------------------------------------------------
def _timed_compile(fn, *args):
    import jax

    t0 = time.time()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.time() - t0


def _lm_solve(problem, state0, iters, lam, label, repeat=False):
    """Compile + run `iters` LM iterations; returns (state, stats). With
    `repeat`, runs again and reports whether the final chi2 is bit-equal
    (XLA's autotuning and atomic scatters may change the last bits)."""
    import jax

    from amcslam_tpu.solver.lm import lm_optimize

    exe, t_c = _timed_compile(
        lambda s: lm_optimize(problem, s, iters, lambda_init=lam), state0)
    t0 = time.time()
    state, stats = jax.block_until_ready(exe(state0))
    c0, c1 = float(stats.initial_chi2), float(stats.chi2)
    print(f"  {label}: compile {t_c:.1f} s, run {time.time() - t0:.3f} s, "
          f"{int(stats.iterations)} LM iterations, chi2 {c0:.6g} -> {c1:.6g}",
          flush=True)
    if repeat:
        c2 = float(jax.block_until_ready(exe(state0))[1].chi2)
        print(f"  {label}: second run chi2 {c2!r} vs {c1!r}, bit-equal "
              f"{c2 == c1}", flush=True)
    return state, stats


def _non_pd_check():
    """LM rejects a trial whose damped solve is not finite (solver/lm.py);
    the GPU's Cholesky and batched inverse must report a non-PD or singular
    system that way rather than return a finite wrong step."""
    import jax
    import jax.numpy as jnp

    b = jnp.ones(12, jnp.float32)

    @jax.jit
    def chol_step(A):
        return jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(A), b)

    step = chol_step(-jnp.eye(12, dtype=jnp.float32))
    inv = jax.jit(jnp.linalg.inv)(jnp.zeros((4, 7, 7), jnp.float32))
    check(not bool(jnp.all(jnp.isfinite(step))),
          "Cholesky of a non-PD damped system gives a non-finite step")
    check(not bool(jnp.all(jnp.isfinite(inv))),
          "batched inverse of singular 7x7 blocks is non-finite")


def solver_phase(tmpdir):
    import jax
    import jax.numpy as jnp

    from amcslam_tpu.solver.ba import make_ba_problem
    from amcslam_tpu.utils.synthetic import make_local_ba_problem

    f32 = jnp.float32
    # local GP-BA, 50 KF / 5k points
    data, state0, _ = make_local_ba_problem(dtype=f32, **LOCAL_BA)
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    _non_pd_check()
    ba_state, st = _lm_solve(problem, state0, 5, 0.0, "local GP-BA 50 KF/5k",
                             repeat=True)
    check(int(st.iterations) >= 5, "local GP-BA ran >= 5 LM iterations")
    check(np.isfinite(float(st.chi2)) and float(st.chi2) < float(st.initial_chi2),
          "local GP-BA chi2 finite and decreasing")
    chi2_f32 = float(jax.jit(problem.chi2)(ba_state))
    proc = start_oracle(ba_state, tmpdir)
    try:
        _solver_checks(proc, chi2_f32)
    finally:
        if proc.poll() is None:  # a failed check leaves no child behind
            proc.kill()
            proc.communicate()


def _solver_checks(proc, chi2_f32):
    import jax
    import jax.numpy as jnp

    from amcslam_tpu.solver.ba import make_ba_problem_pcg
    from amcslam_tpu.solver.pose_solver import pose_gp_optimize
    from amcslam_tpu.solver.sim3_opt import make_essential_graph_problem_pcg
    from amcslam_tpu.utils.synthetic import (
        make_essential_graph,
        make_local_ba_problem,
        make_pose_problem,
    )

    f32 = jnp.float32
    # pose solve 4x10
    pdata, pstate0, _ = make_pose_problem(dtype=f32, **POSE)
    om = jnp.zeros(pdata.mg_obs.shape[0], bool)
    os_ = jnp.zeros(pdata.st_obs.shape[0], bool)
    exe, t_c = _timed_compile(pose_gp_optimize, pdata, pstate0, om, os_)
    t0 = time.time()
    ps, _, _, (_, n_in) = jax.block_until_ready(exe(pdata, pstate0, om, os_))
    print(f"  pose solve 4x10: compile {t_c:.1f} s, run "
          f"{(time.time() - t0) * 1e3:.2f} ms, inliers {int(n_in)}", flush=True)
    pose_T = np.asarray(ps.T, np.float64)

    # essential graph 5000 KF, PCG
    edata, estate0, _ = make_essential_graph(dtype=f32, **EG)
    eprob = make_essential_graph_problem_pcg(edata, pcg_iters=100, pcg_tol=1e-3)
    _, st = _lm_solve(eprob, estate0, 2, 1e-16, "essential graph 5000 KF (PCG)")
    check(np.isfinite(float(st.chi2)) and float(st.chi2) < float(st.initial_chi2),
          "essential graph chi2 finite and decreasing")

    # global BA 2000 KF / 10k points, PCG
    gdata, gstate0, _ = make_local_ba_problem(dtype=f32, **GBA)
    gdata = gdata._replace(gp_huber=jnp.asarray(True))
    gprob = make_ba_problem_pcg(gdata, gdata.mg_valid, gdata.sg_valid,
                                gdata.st_valid, pcg_iters=40, pcg_tol=1e-3)
    _, st = _lm_solve(gprob, gstate0, 2, 1e-5, "global BA 2000 KF/10k (PCG)")
    check(np.isfinite(float(st.chi2)) and float(st.chi2) < float(st.initial_chi2),
          "global BA chi2 finite and decreasing")

    ref = finish_oracle(proc)
    r = rel(chi2_f32, ref["local_ba_chi2"])
    print(f"  local GP-BA chi2: f32 card {chi2_f32:.9g}, f64 CPU "
          f"{ref['local_ba_chi2']:.9g}", flush=True)
    check(r <= LOCAL_BA_CHI2_RTOL,
          f"local GP-BA f32-vs-f64 chi2 rel {r:.3e} <= {LOCAL_BA_CHI2_RTOL:g}")
    T64 = np.asarray(ref["pose_T"])
    dt = float(np.linalg.norm(pose_T[1, :3, 3] - T64[1, :3, 3]))
    dr = _rot_angle(pose_T[1, :3, :3], T64[1, :3, :3])
    dn = abs(int(n_in) - ref["pose_inliers"])
    check(dt <= POSE_T_TOL_M,
          f"pose solve translation vs f64 {dt:.3e} m <= {POSE_T_TOL_M:g}")
    check(dr <= POSE_R_TOL_RAD,
          f"pose solve rotation vs f64 {dr:.3e} rad <= {POSE_R_TOL_RAD:g}")
    check(dn <= POSE_INLIER_TOL,
          f"pose solve inliers {int(n_in)} vs f64 {ref['pose_inliers']} "
          f"(|diff| {dn} <= {POSE_INLIER_TOL})")


# --- pipeline ---------------------------------------------------------------
def _orb_agreement(host, dev):
    """(count rel diff, co-located share of host keypoints, median Hamming)
    for one image: same-level keypoints within 1.5 px."""
    xy_h, oc_h, de_h, _ = host
    xy_d, oc_d, de_d, _ = dev
    matched, hamm = 0, []
    for lv in np.unique(oc_h):
        a, b = xy_h[oc_h == lv], xy_d[oc_d == lv]
        if len(a) == 0 or len(b) == 0:
            continue
        d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, -1)
        j = np.argmin(d2, axis=1)
        hit = d2[np.arange(len(a)), j] < 1.5 ** 2
        matched += int(hit.sum())
        da, db = de_h[oc_h == lv], de_d[oc_d == lv]
        hamm += [int(np.unpackbits(da[i] ^ db[j[i]]).sum())
                 for i in np.where(hit)[0]]
    n_h = max(len(xy_h), 1)
    return (abs(len(xy_d) - len(xy_h)) / n_h, matched / n_h,
            float(np.median(hamm)) if hamm else float("inf"))


def orb_check(size=RIG_RUN["size"], n_async=RIG_RUN["n_async"],
              n_features=RIG_RUN["n_features"]):
    import e2e_rendered as e2e

    from amcslam_tpu.frontend.features import make_extractors

    planes = e2e.make_world(0)
    rig = e2e.make_rig(n_async, size)
    ts = 0.0
    cam_t = rig.cam_times(ts)
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    views = [e2e.gt_pose(cam_t[c]) @ rig.Tbc[c] for c in range(rig.n_cams)]
    views.append(e2e.gt_pose(ts) @ rig.Tbc[-1] @ Tright)
    imgs = e2e.make_device_renderer(planes, size=size)(views)
    n = len(imgs)
    host = make_extractors(n, n_features, backend="host")
    dev = make_extractors(n, n_features, backend="device")
    t0 = time.time()
    out_h = [host[i].extract(imgs[i]) for i in range(n)]
    t_h = time.time() - t0
    batch = np.stack(imgs)
    t0 = time.time()
    dev[-1].extract_batch(batch)
    t_first = time.time() - t0
    t0 = time.time()
    out_d = list(zip(*dev[-1].extract_batch(batch)))
    t_d = time.time() - t0
    print(f"  ORB on {n} images {size[0]}x{size[1]}: host {t_h * 1e3:.1f} ms "
          f"(serial), device {t_d * 1e3:.1f} ms (batched; first call "
          f"{t_first:.1f} s)", flush=True)
    worst = (0.0, 1.0, 0.0)
    for i in range(n):
        cnt, col, ham = _orb_agreement(out_h[i], out_d[i])
        print(f"  image {i}: host {len(out_h[i][0])} kp, device "
              f"{len(out_d[i][0])} kp, co-located {col:.3f}, median "
              f"Hamming {ham:.1f}", flush=True)
        worst = (max(worst[0], cnt), min(worst[1], col), max(worst[2], ham))
    check(worst[0] <= ORB_COUNT_RTOL,
          f"ORB keypoint count rel diff {worst[0]:.3f} <= {ORB_COUNT_RTOL}")
    check(worst[1] >= ORB_COLOCATED_MIN,
          f"ORB co-located share {worst[1]:.3f} >= {ORB_COLOCATED_MIN}")
    check(worst[2] <= ORB_HAMMING_MEDIAN_MAX,
          f"ORB median Hamming {worst[2]:.1f} <= {ORB_HAMMING_MEDIAN_MAX}")


def _map_count():
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def _report_run(label, ate, dist, n_loops, collect, clock, c0, t0):
    sysm = collect["system"]
    m = sysm.atlas.active
    lat = np.asarray(collect["timing"]["track_ms"])
    steady = lat[10:] if len(lat) > 20 else lat
    print(f"  {label}: frames {len(lat)}, wall {time.time() - t0:.1f} s, "
          f"compile {clock.total - c0:.1f} s, first frame {lat[0]:.0f} ms",
          flush=True)
    print(f"  {label}: tracking p50 {np.percentile(lat, 50):.1f} ms, p95 "
          f"{np.percentile(lat, 95):.1f} ms (n={len(lat)}); after frame 10: "
          f"p50 {np.percentile(steady, 50):.1f} ms, p95 "
          f"{np.percentile(steady, 95):.1f} ms (n={len(steady)})", flush=True)
    print(f"  {label}: keyframes {len(m.keyframes)}, map points "
          f"{len(m.map_points)}, loops {n_loops}, ATE {ate:.4f} m over "
          f"{dist:.1f} m ({100 * ate / max(dist, 1e-9):.3f} %)", flush=True)
    return sysm


def pipeline_phase(clock, rig_run=RIG_RUN, loop_run=LOOP_RUN):
    import e2e_rendered as e2e

    from amcslam_tpu.pipeline.tracking import TrackState

    orb_check(rig_run["size"], rig_run["n_async"], rig_run["n_features"])
    maps0 = _map_count()

    collect = {}
    t0, c0 = time.time(), clock.total
    ate, dist, n_loops = e2e.run(collect=collect, **rig_run)
    sysm = _report_run("AMV rig", ate, dist, n_loops, collect, clock, c0, t0)
    states = collect["states"]
    n_ok = sum(s == TrackState.OK for s in states[1:])
    check(n_ok == len(states) - 1,
          f"AMV rig tracking OK on {n_ok}/{len(states) - 1} frames after the "
          "first")
    check(ate < RIG_ATE_FRAC * dist,
          f"AMV rig ATE {ate:.4f} m < {RIG_ATE_FRAC} x {dist:.2f} m")
    check(sysm.rig.n_cams == rig_run["n_async"] + 1, "AMV rig has 6 cameras")
    n_async_obs = sum(
        1 for mp in sysm.atlas.active.map_points.values()
        for slots in mp.observations.values()
        for g in slots[:-1] if g >= 0)
    check(n_async_obs > 0, f"async-camera observations in the map: {n_async_obs}")

    collect = {}
    t0, c0 = time.time(), clock.total
    ate, dist, n_loops = e2e.run(collect=collect, **loop_run)
    _report_run("loop course", ate, dist, n_loops, collect, clock, c0, t0)
    check(n_loops >= 1, f"loop course closed {n_loops} loop(s) >= 1")
    check(np.isfinite(ate) and ate < LOOP_ATE_FRAC * dist,
          f"loop course ATE {ate:.4f} m < {LOOP_ATE_FRAC} x {dist:.2f} m")
    maps1 = _map_count()
    print(f"  /proc/self/maps lines: {maps0} before the runs, {maps1} after "
          f"(+{maps1 - maps0})", flush=True)


# --- four devices -----------------------------------------------------------
def _live_bytes(devs):
    """Bytes of live jax arrays held on each device (exact, from shards)."""
    import jax

    per = {d: 0 for d in devs}
    for a in jax.live_arrays():
        for sh in a.addressable_shards:
            if sh.device in per:
                per[sh.device] += sh.data.nbytes
    return [per[d] for d in devs]


def _check_sharded(name, arr, mesh, spec_axis):
    sh = arr.sharding
    devs = {s.device for s in arr.addressable_shards}
    shapes = sorted({tuple(s.data.shape) for s in arr.addressable_shards})
    print(f"  {name}: sharding {sh}, {len(devs)} devices, shard shapes "
          f"{shapes}", flush=True)
    check(len(devs) == mesh.size and getattr(sh, "spec", None) is not None
          and spec_axis in tuple(sh.spec),
          f"{name} split over all {mesh.size} devices on axis {spec_axis!r}")


def four_phase(n_dev=4, local_ba=LOCAL_BA, eg=EG):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from amcslam_tpu.parallel.sharded_ba import (
        _shard_fields,
        make_sharded_ba_problem,
        shard_ba_data,
    )
    from amcslam_tpu.parallel.sharded_eg import make_sharded_eg_problem, shard_eg_data
    from amcslam_tpu.solver.ba import BAState, LocalBAData, make_ba_problem
    from amcslam_tpu.solver.sim3_opt import make_essential_graph_problem_pcg
    from amcslam_tpu.utils.synthetic import make_essential_graph, make_local_ba_problem

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"{n_dev} devices present")
    cpu = jax.devices("cpu")[0]
    f32 = jnp.float32
    # problems are built on the host CPU device, then placed shard by shard
    # from host memory, so no copy lands on device 0 by default
    with jax.default_device(cpu):
        data, state0, _ = make_local_ba_problem(dtype=f32, **local_ba)
        sb = shard_ba_data(data, state0, n_dev)
        edata, estate0, _ = make_essential_graph(dtype=f32, **eg)
        se = shard_eg_data(edata, n_dev)

    mesh = Mesh(np.array(devs), ("l",))
    shard = _shard_fields(n_dev)
    put = lambda a, spec: None if a is None else jax.device_put(
        np.asarray(a), NamedSharding(mesh, spec))
    sdata = LocalBAData(**{
        f: put(getattr(sb.data, f), P("l") if f in shard else P())
        for f in LocalBAData._fields})
    sstate = BAState(T=put(sb.state0.T, P()), v=put(sb.state0.v, P()),
                     Text=put(sb.state0.Text, P()), X=put(sb.state0.X, P("l")))
    _check_sharded("sharded BA landmarks X", sstate.X, mesh, "l")
    _check_sharded("sharded BA stereo edges", sdata.st_obs, mesh, "l")
    sproblem = make_sharded_ba_problem(mesh, sb._replace(data=sdata))
    s_ba, st_s = _lm_solve(sproblem, sstate, 5, 1.0, f"sharded BA on {n_dev}")
    _check_sharded("sharded BA result X", s_ba.X, mesh, "l")

    mesh_e = Mesh(np.array(devs), ("e",))
    pute = lambda a, spec: jax.device_put(np.asarray(a),
                                          NamedSharding(mesh_e, spec))
    sed = se.data._replace(**{f: pute(getattr(se.data, f), P("e")) for f in
                              ("pairs", "meas_s", "meas_R", "meas_t", "valid")})
    sed = sed._replace(fixed=pute(sed.fixed, P()),
                       fix_scale=pute(sed.fix_scale, P()))
    _check_sharded("sharded EG edges", sed.meas_t, mesh_e, "e")
    eprob_s = make_sharded_eg_problem(mesh_e, se._replace(data=sed),
                                      pcg_iters=100, pcg_tol=1e-3)
    est0 = jax.tree.map(lambda a: pute(a, P()), estate0)
    _, st_es = _lm_solve(eprob_s, est0, 5, 1e-16, f"sharded EG on {n_dev}")

    live = _live_bytes(devs)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    print(f"  after the sharded solves: live array bytes per device {live}, "
          f"allocator peak bytes per device {peaks}", flush=True)
    ratio = max(live) / max(min(live), 1)
    check(ratio <= SHARD_MEM_RATIO_MAX,
          f"live array bytes ratio across devices {ratio:.3f} <= "
          f"{SHARD_MEM_RATIO_MAX}")

    # one-device references on device 0
    with jax.default_device(devs[0]):
        d1 = jax.device_put(data, devs[0])
        s1 = jax.device_put(state0, devs[0])
        p1 = make_ba_problem(d1, d1.mg_valid, d1.sg_valid, d1.st_valid)
        _, st_1 = _lm_solve(p1, s1, 5, 1.0, "one-device BA")
        e1 = jax.device_put(edata, devs[0])
        ep1 = make_essential_graph_problem_pcg(e1, pcg_iters=100, pcg_tol=1e-3)
        _, st_e1 = _lm_solve(ep1, jax.device_put(estate0, devs[0]), 5, 1e-16,
                             "one-device EG")

    for name, a, b, tol in (
        ("sharded BA", st_s, st_1, SHARD_BA_CHI2_RTOL),
        ("sharded EG", st_es, st_e1, SHARD_EG_CHI2_RTOL),
    ):
        r0 = rel(float(a.initial_chi2), float(b.initial_chi2))
        r1 = rel(float(a.chi2), float(b.chi2))
        check(r0 <= SHARD_CHI2_RTOL_INIT,
              f"{name} initial chi2 rel {r0:.3e} <= {SHARD_CHI2_RTOL_INIT:g}")
        check(np.isfinite(float(a.chi2)) and r1 <= tol,
              f"{name} final chi2 rel {r1:.3e} <= {tol:g} "
              f"({float(a.chi2):.6g} vs {float(b.chi2):.6g})")


# --- main -------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded solvers on 4 GPUs")
    ap.add_argument("--oracle", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.oracle:
        oracle(args.oracle)
        return 0

    t_start = time.time()
    try:
        d0 = gate(need_native=not args.four)
        import jax

        clock = CompileClock()
        if args.four:
            with Phase("four-device sharded solvers", clock):
                four_phase()
        else:
            with tempfile.TemporaryDirectory() as td:
                with Phase("solvers", clock):
                    solver_phase(td)
            with Phase("pipeline", clock):
                pipeline_phase(clock)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"total wall {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
