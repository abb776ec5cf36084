"""End-to-end on RENDERED IMAGES: textured-corridor world -> per-camera
pinhole rendering -> native ORB extraction -> full SLAM pipeline -> ATE.

This is the whole stack the way a user runs it (multicam_amv.cc semantics:
images in, trajectory out) — nothing is fed synthetic keypoints or oracle
descriptors; every match comes from rBRIEF on rendered pixels.

Usage: python examples/e2e_rendered.py [--frames N] [--size 960x600]
                                       [--plot out.png]
Prints per-stage timing and the final ATE RMSE vs the ground-truth
trajectory.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from amcslam_tpu.frontend.features import build_frame, make_extractors
from amcslam_tpu.pipeline.rig import Rig
from amcslam_tpu.pipeline.system import System
from amcslam_tpu.pipeline.tracking import TrackingConfig
from amcslam_tpu.utils.io import ate_rmse

SIZE = (640, 480)  # default (width, height) of every rendered camera


def camera_k4(size=SIZE) -> np.ndarray:
    """Pinhole (fx, fy, cx, cy) for a (width, height) image: square pixels,
    principal point at the centre, and the same horizontal field of view
    (77 deg) at every width (fx = 400 at 640 px)."""
    w, h = size
    f = 400.0 * w / 640.0
    return np.array([f, f, w / 2.0, h / 2.0])


def _pinhole_rays(size=SIZE) -> np.ndarray:
    """(H, W, 3) unit-depth rays of the camera_k4 pinhole."""
    w, h = size
    fx, fy, cx, cy = camera_k4(size)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([(u - cx) / fx, (v - cy) / fy, np.ones((h, w))], -1)


def make_world(seed=0, half=4.0, ceiling=4.0, span=12.0):
    """Textured box: ground, ceiling, two walls (at y = +-half). Blocky
    random textures (strong FAST corners at block edges) + fine noise; the
    texture tiles every `span` meters — keep `span` >= the scene extent for
    loop-closure scenarios so places stay visually distinct."""
    rng = np.random.RandomState(seed)

    def tex(n_blocks=96, up=6):
        t = rng.randint(30, 226, (n_blocks, n_blocks)).astype(np.float64)
        t = np.kron(t, np.ones((up, up)))
        t += rng.randn(*t.shape) * 6.0
        return np.clip(t, 0, 255)

    # (p0, n, e1, e2, texture, scale [texels per meter])
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    s = 96 * 6 / span
    return [
        (np.array([0, 0, 0.0]), ez, ex, ey, tex(), s),          # ground z=0
        (np.array([0, 0, ceiling]), -ez, ex, ey, tex(), s),     # ceiling
        (np.array([0, -half, 0]), ey, ex, ez, tex(), s),        # wall y=-h
        (np.array([0, half, 0]), -ey, ex, ez, tex(), s),        # wall y=+h
    ]


def render(Twc: np.ndarray, planes, ray_grid: np.ndarray | None = None,
           size=SIZE) -> np.ndarray:
    """Ray-cast one view of the textured box (nearest-texel). Default is
    the camera_k4 pinhole at `size`; pass `ray_grid` (H,W,3 unit-depth
    rays, e.g. cameras.kb8_ray_grid) to render through another camera
    model."""
    if ray_grid is None:
        ray_grid = _pinhole_rays(size)
    H, W = ray_grid.shape[:2]
    d_cam = ray_grid.reshape(-1, 3).T
    Rwc, t = Twc[:3, :3], Twc[:3, 3]
    d = Rwc @ d_cam  # (3, N)
    best_t = np.full(W * H, np.inf)
    val = np.zeros(W * H)
    for p0, n, e1, e2, texture, scale in planes:
        denom = n @ d
        with np.errstate(divide="ignore", invalid="ignore"):
            ti = (n @ (p0 - t)) / denom
        ok = (denom < -1e-9) & (ti > 0.2) & (ti < best_t)
        if not ok.any():
            continue
        hit = t[:, None] + d * ti[None, :]
        s1 = ((hit - p0[:, None]).T @ e1) * scale
        s2 = ((hit - p0[:, None]).T @ e2) * scale
        hh, ww = texture.shape
        i1 = np.mod(np.floor(s1).astype(np.int64), hh)
        i2 = np.mod(np.floor(s2).astype(np.int64), ww)
        sample = texture[i1, i2]
        val = np.where(ok, sample, val)
        best_t = np.where(ok, ti, best_t)
    return np.clip(val, 0, 255).astype(np.uint8).reshape(H, W)


def make_device_renderer(planes, ray_grids: np.ndarray | None = None,
                         size=SIZE):
    """The ray-caster as one jitted XLA program: all cameras' views render
    in a single device dispatch (same plane-intersection + nearest-texel
    semantics as `render`). This moves the demo loop's one CPU-bound stage
    that is not part of the pipeline onto the device, which is what makes
    multi-hundred-meter full-stack runs practical."""
    import jax
    import jax.numpy as jnp

    p0 = jnp.asarray(np.stack([p[0] for p in planes]), jnp.float32)
    nrm = jnp.asarray(np.stack([p[1] for p in planes]), jnp.float32)
    e1 = jnp.asarray(np.stack([p[2] for p in planes]), jnp.float32)
    e2 = jnp.asarray(np.stack([p[3] for p in planes]), jnp.float32)
    tex = jnp.asarray(np.stack([p[4] for p in planes]), jnp.float32)
    scale = jnp.asarray(np.array([p[5] for p in planes]), jnp.float32)
    d_cam = _pinhole_rays(size).astype(np.float32)  # (H, W, 3)
    if ray_grids is None:
        grids = None
        d_cam = jnp.asarray(d_cam)
    else:
        # per-view ray grids (V,H,W,3): views with a camera model other
        # than the default pinhole (e.g. KB8 fisheye) carry their own rays
        grids = jnp.asarray(np.asarray(ray_grids, np.float32))

    @jax.jit
    def render_batch(Twc):  # (C,4,4) -> (C,H,W) uint8
        def one(T, d_cam):
            Rwc, t = T[:3, :3], T[:3, 3]
            d = d_cam @ Rwc.T                      # (H,W,3) world rays
            denom = d @ nrm.T                      # (H,W,P)
            num = jnp.einsum("pi,pi->p", nrm, p0 - t[None, :])
            ti = num[None, None, :] / denom
            ok = (denom < -1e-9) & (ti > 0.2)
            ti = jnp.where(ok, ti, jnp.inf)
            best = jnp.argmin(ti, axis=-1)         # (H,W)
            tbest = jnp.min(ti, axis=-1)
            valid = jnp.isfinite(tbest)
            tsafe = jnp.where(valid, tbest, 1.0)
            hit = t[None, None, :] + d * tsafe[..., None]
            rel = hit - p0[best]
            s1 = jnp.einsum("hwi,hwi->hw", rel, e1[best]) * scale[best]
            s2 = jnp.einsum("hwi,hwi->hw", rel, e2[best]) * scale[best]
            i1 = jnp.mod(jnp.floor(s1).astype(jnp.int32), tex.shape[1])
            i2 = jnp.mod(jnp.floor(s2).astype(jnp.int32), tex.shape[2])
            val = tex[best, i1, i2]
            val = jnp.where(valid, val, 0.0)
            return jnp.clip(val, 0, 255).astype(jnp.uint8)

        if grids is None:
            return jax.vmap(one, in_axes=(0, None))(Twc, d_cam)
        return jax.vmap(one)(Twc, grids)

    def render_all(Twc_list):
        out = render_batch(jnp.asarray(np.stack(Twc_list), jnp.float32))
        return list(np.asarray(jax.device_get(out)))

    # async pair: dispatch returns the un-fetched device buffer (JAX async
    # dispatch), so the next frame's render overlaps host-side tracking
    render_all.dispatch = lambda Twc_list: render_batch(
        jnp.asarray(np.stack(Twc_list), jnp.float32))
    render_all.fetch = lambda h: list(np.asarray(jax.device_get(h)))
    return render_all


def make_rig(n_async: int = 2, size=SIZE) -> Rig:
    """`n_async` async monos (yawed around the body) + forward stereo pair,
    all with the camera_k4 pinhole of `size`.

    n_async=2 is the compact test rig; n_async=5 reproduces the reference's
    AMV convention of 5 async cameras + 1 stereo pair = 7 images per tick
    (orb_multicam.yaml:3-14, System.cc:213-218)."""

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    def cam_T(yaw):
        # camera: +z optical forward, +x right, +y down -> body (+x fwd,
        # +y left, +z up)
        T = np.eye(4)
        R_b_cam = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
        T[:3, :3] = rotz(yaw) @ R_b_cam
        return T

    if n_async == 2:
        yaws = [0.5, -0.5]
    else:
        # spread across the forward hemisphere + flanks (AMV-style surround)
        yaws = list(np.linspace(1.6, -1.6, n_async))
    Tbc = np.stack([cam_T(y) for y in yaws] + [cam_T(0.0)])
    K4 = camera_k4(size)
    K = np.tile(K4, (n_async + 1, 1))
    return Rig(Tbc=Tbc, K=K, bf=K4[0] * 0.2,  # 0.2 m stereo baseline
               qc_diag=np.full(6, 1.0), n_levels=8)


def gt_pose(t: float) -> np.ndarray:
    """Smooth forward trajectory with gentle yaw/lateral wiggle."""
    x = 1.0 * t
    y = 0.35 * np.sin(0.35 * t)
    yaw = 0.35 * 0.35 * np.cos(0.35 * t)  # dy/dx heading
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T[:3, 3] = [x, y, 1.5]
    return T


def gt_pose_circle(t: float, period: float = 10.0, radius: float = 1.5):
    """Closed circular trajectory (tangent heading): revisits its start
    after `period` seconds, driving the loop-closing path."""
    a = 2 * np.pi * t / period
    yaw = a + np.pi / 2
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 1.5]
    return T


def gt_pose_eight(t: float, period: float = 16.0, radius: float = 5.0):
    """Figure-eight of two externally tangent circles, both transited
    through the tangent point (0,0) heading +y — so the junction region is
    revisited in the SAME direction on every transit, and each circle's lap
    closure revisits its own start. `period` is the time for ONE circle;
    the full eight takes 2*period. Circle A (center (-R,0)) runs
    counter-clockwise, circle B (center (+R,0)) clockwise:

      A: p = (-R + R cos u,  R sin u),  yaw = u + pi/2
      B: p = ( R - R cos u,  R sin u),  yaw = pi/2 - u

    (headings match at u = 0 mod 2pi, so the path is C1 at the junction).
    Driving 2+ transits fires MULTIPLE sequential loop closures from the
    keyframe database — the reference's continuous multi-loop replay shape
    (multicam_amv.cc:61-137 over a course with several revisits)."""
    u = 2 * np.pi * (t % period) / period
    on_b = int(t // period) % 2 == 1
    if on_b:
        pos = [radius - radius * np.cos(u), radius * np.sin(u)]
        yaw = np.pi / 2 - u
    else:
        pos = [-radius + radius * np.cos(u), radius * np.sin(u)]
        yaw = np.pi / 2 + u
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T[:3, 3] = [pos[0], pos[1], 1.5]
    return T


def run(n_frames=50, fps=10.0, seed=0, plot=None, threaded=False,
        circle=False, circle_period=16.0, circle_radius=5.0,
        n_features=800, device_render=False, eight=False, n_async=2,
        blackout=None, collect=None, fisheye=False, pace=False,
        size=SIZE):
    """`eight=True`: figure-eight course with multiple same-direction
    revisits (multi-loop closures). `n_async`: async mono count (5 = the
    AMV rig width, 7 images/tick). `blackout=(k0, n)`: frames k0..k0+n-1
    render black — tracking must ride OK -> RECENTLY_LOST -> relocalize.
    `fisheye=True`: async camera 0 becomes a KannalaBrandt8 fisheye —
    rendered through kb8_ray_grid, keypoints lifted by the exact Newton
    inversion (Settings.h:46-50 keeps KB8 live upstream).
    `pace=True`: replay at the sensor rate (frame k is not submitted
    before wall time k/fps, the reference's real-time replay protocol,
    multicam_amv.cc:117-126) — the meaningful protocol for `threaded`
    runs, where the background mapper/loop-closer only gets the wall time
    tracking leaves unused; without pacing an offline replay starves it
    by construction. Render/extract time beyond the frame budget counts
    against pacing like a slow sensor would.
    `size`: (width, height) of every camera image; intrinsics scale with
    it (camera_k4).
    `collect`: optional dict that receives per-frame states + the System."""
    if eight:
        half = max(12.0, 2.0 * circle_radius + 10.0)
        planes = make_world(seed, half=half, ceiling=6.0,
                            span=max(40.0, 2.0 * half + 8.0))
        pose_fn = lambda t: gt_pose_eight(t, circle_period, circle_radius)
    elif circle:
        # loop-closure scenario: a big circle in a big non-repeating box so
        # the far side looks different from the start, odometry drift
        # accumulates over the lap, and the revisit must be closed by the
        # loop-closing thread (detection via the keyframe database).
        # The box scales with the radius so multi-hundred-meter courses fit
        # (texture span >= box extent keeps places visually distinct).
        half = max(12.0, circle_radius + 10.0)
        planes = make_world(seed, half=half, ceiling=6.0,
                            span=max(40.0, 2.0 * half + 8.0))
        pose_fn = lambda t: gt_pose_circle(t, circle_period, circle_radius)
    else:
        planes = make_world(seed)
        pose_fn = gt_pose
    rig = make_rig(n_async, size)
    C = rig.n_cams
    kb8_grid = None
    if fisheye:
        from amcslam_tpu.frontend.cameras import CAMERA_KB8, kb8_ray_grid

        # async camera 0 becomes a KB8 fisheye: shorter focal (wider FOV)
        # + a theta-polynomial with visible distortion at the image edges
        w, h = size
        f = 300.0 * w / 640.0
        kb8 = np.array([f, f, w / 2.0, h / 2.0, 0.05, -0.01, 0.002, 0.0])
        rig.K[0] = kb8[:4]
        rig.cam_model = np.zeros(C, np.int32)
        rig.cam_model[0] = CAMERA_KB8
        rig.kb8_params = np.zeros((C, 8))
        rig.kb8_params[0] = kb8
        kb8_grid = kb8_ray_grid(kb8, *size)
    ray_grids = None
    if kb8_grid is not None:
        pin = _pinhole_rays(size)
        ray_grids = np.stack([kb8_grid] + [pin] * C)  # views: C cams + right
    renderer = (make_device_renderer(planes, ray_grids, size)
                if device_render else None)
    extractors = make_extractors(C + 1, n_features)
    cfg = TrackingConfig(max_frames_between_kf=5, min_local_matches=15,
                         ransac_min_match=15)
    slam = System(rig, tracking_config=cfg, threaded=threaded)

    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]  # stereo right offset in camera frame

    def frame_views(k):
        ts = k / fps
        cam_times = rig.cam_times(ts)
        views = [pose_fn(cam_times[c]) @ rig.Tbc[c] for c in range(C)]
        views.append(pose_fn(ts) @ rig.Tbc[C - 1] @ Tright)
        return views

    gt_t, gt_T = [], []
    track_times = []
    states = []
    t_render = t_extract = t_track = 0.0
    pending = renderer.dispatch(frame_views(0)) if renderer is not None else None
    t_wall0 = time.time()
    for k in range(n_frames):
        ts = k / fps
        cam_times = rig.cam_times(ts)
        if pace:
            lag = t_wall0 + k / fps - time.time()
            if lag > 0:
                time.sleep(lag)
        t0 = time.time()
        if renderer is not None:
            *imgs, img_r = renderer.fetch(pending)
            if k + 1 < n_frames:  # overlap next render with this frame's work
                pending = renderer.dispatch(frame_views(k + 1))
        else:
            *imgs, img_r = [
                render(T, planes,
                       ray_grid=ray_grids[i] if ray_grids is not None else None,
                       size=size)
                for i, T in enumerate(frame_views(k))
            ]
        if blackout is not None and blackout[0] <= k < blackout[0] + blackout[1]:
            # sensor dropout: the tracker sees featureless black frames
            imgs = [np.zeros_like(im) for im in imgs]
            img_r = np.zeros_like(img_r)
        t_render += time.time() - t0

        t0 = time.time()
        frame = build_frame(imgs, cam_times, rig, extractors, right_image=img_r)
        t_extract += time.time() - t0

        t0 = time.time()
        state = slam.track_multicamera(frame)
        dt_track = time.time() - t0
        t_track += dt_track
        track_times.append(dt_track)
        states.append(state)

        gt_t.append(ts)
        gt_T.append(pose_fn(ts))
        if (k + 1) % 50 == 0:
            n_loops = (getattr(slam.loop_closer, "loops_closed", 0)
                       if slam.loop_closer else 0)
            recent = track_times[-50:]
            print(f"  [{k+1}/{n_frames}] kf={len(slam.atlas.active.keyframes)}"
                  f" mp={len(slam.atlas.active.map_points)} loops={n_loops}"
                  f" track_med={np.median(recent)*1e3:.0f}ms", flush=True)

    slam.shutdown()
    traj = slam.tracker.trajectory_poses()
    est_t = np.array([t for t, _ in traj])
    est_T = np.stack([T for _, T in traj])
    ate, _ = ate_rmse(est_t, est_T, np.array(gt_t), np.stack(gt_T))
    dist = np.sum(np.linalg.norm(np.diff(np.stack(gt_T)[:, :3, 3], axis=0),
                                 axis=1))
    n_kf = len(slam.atlas.active.keyframes)
    n_mp = len(slam.atlas.active.map_points)
    n_loops = getattr(slam.loop_closer, "loops_closed", 0) if slam.loop_closer else 0
    print(f"frames={n_frames} dist={dist:.1f}m kf={n_kf} mp={n_mp} loops={n_loops}")
    print(f"render  {t_render/n_frames*1e3:7.1f} ms/frame (synthetic world, "
          "not part of the pipeline)")
    print(f"extract {t_extract/n_frames*1e3:7.1f} ms/frame ({C + 1} images)")
    tail = track_times[-10:] if len(track_times) >= 20 else track_times
    print(f"track   {t_track/n_frames*1e3:7.1f} ms/frame mean, "
          f"{np.median(track_times)*1e3:.1f} ms median, "
          f"{np.mean(tail)*1e3:.1f} ms steady-state (last {len(tail)}) "
          "(matching+solvers+mapping; mean includes one-time jit traces)")
    print(f"ATE RMSE {ate:.4f} m  ({100*ate/max(dist,1e-9):.2f}% of "
          f"{dist:.1f} m)")
    if os.environ.get("AMCSLAM_STAGE_STATS"):
        from amcslam_tpu.utils.timing import GLOBAL_TIMER

        GLOBAL_TIMER.print_stats()
    if plot:
        from amcslam_tpu.pipeline.viewer import draw_map

        draw_map(slam.atlas.active, trajectory=traj,
                 path=plot)
        print(f"map render -> {plot}")
    if collect is not None:
        collect["states"] = states
        collect["system"] = slam
        collect["est"] = (est_t, est_T)
        collect["gt"] = (np.array(gt_t), np.stack(gt_T))
        collect["timing"] = {
            "extract_ms": t_extract / n_frames * 1e3,
            "track_ms_median": float(np.median(track_times) * 1e3),
            "track_ms": [float(x * 1e3) for x in track_times],
        }
    return ate, dist, n_loops


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--plot", default=None)
    ap.add_argument("--circle", action="store_true",
                    help="closed circular trajectory (exercises loop closing)")
    ap.add_argument("--period", type=float, default=16.0)
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--features", type=int, default=800)
    ap.add_argument("--threaded", action="store_true",
                    help="run mapping/loop-closing in a background thread "
                         "(the reference's thread layout); tracking latency "
                         "then excludes local BA")
    ap.add_argument("--device-render", action="store_true",
                    help="ray-cast the world on the accelerator (one jitted "
                         "dispatch for all cameras) instead of host NumPy")
    ap.add_argument("--eight", action="store_true",
                    help="figure-eight course: multiple same-direction "
                         "revisits -> multiple sequential loop closures")
    ap.add_argument("--n-async", type=int, default=2,
                    help="async mono cameras (5 = AMV rig, 7 images/tick)")
    ap.add_argument("--fisheye", action="store_true",
                    help="async camera 0 is a KannalaBrandt8 fisheye")
    ap.add_argument("--pace", action="store_true",
                    help="replay at the sensor rate (real-time pacing, as "
                         "multicam_amv does) — required for meaningful "
                         "--threaded runs")
    ap.add_argument("--size", default="640x480",
                    help="WxH of every camera image (960x600 = AMV rig)")
    ap.add_argument("--blackout", default=None,
                    help="K0:N — render frames K0..K0+N-1 black "
                         "(relocalization scenario)")
    args = ap.parse_args()
    n = args.frames
    if args.circle and n == 50:
        n = int(args.period * args.fps) + int(2 * args.fps)  # lap + revisit
    if args.eight and n == 50:
        # A, B, then re-enter A: three junction transits + two lap closures
        n = int(2.2 * args.period * args.fps)
    blackout = None
    if args.blackout:
        k0, nb = args.blackout.split(":")
        blackout = (int(k0), int(nb))
    run(n_frames=n, fps=args.fps, plot=args.plot, circle=args.circle,
        circle_period=args.period, circle_radius=args.radius,
        n_features=args.features, threaded=args.threaded,
        device_render=args.device_render, eight=args.eight,
        n_async=args.n_async, blackout=blackout, fisheye=args.fisheye,
        pace=args.pace, size=tuple(int(x) for x in args.size.split("x")))
