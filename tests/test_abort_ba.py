"""BA interruption semantics (round-4 VERDICT item 1).

The reference lets tracking preempt a running LocalGPBA through the
mbAbortBA force-stop (LocalMapping.cc:131/215, g2o setForceStopFlag via
Optimizer.cc:79-80) and runs the post-loop global BA on a detached,
abortable thread with staged write-back that propagates to keyframes
created during the BA (LoopClosing.cc:811-835, 1206-1339). These tests pin
the device-side counterparts:

  * host-segmented LM (solver/lm.py LMCarry) is BIT-IDENTICAL to the
    monolithic jitted loop when no abort fires,
  * an abort stops the schedule at a segment boundary and the partial
    iterate is still usable,
  * the detached GBA stages its write-back: a keyframe inserted mid-solve
    is corrected through its prev-chain parent (mTbwGBA semantics), and a
    superseded GBA (mnFullBAIdx bumped) discards its result.
"""

import threading

import numpy as np
import jax
import jax.numpy as jnp

from amcslam_tpu.solver.ba import (
    global_ba,
    global_ba_interruptible,
    local_gp_ba,
    local_gp_ba_interruptible,
)
from amcslam_tpu.utils.synthetic import make_local_ba_problem

from test_loop_closing import build_loop_map


def _problem(**kw):
    kw.setdefault("n_kf", 6)
    kw.setdefault("n_fixed", 1)
    kw.setdefault("n_lm", 48)
    kw.setdefault("obs_per_lm", 3)
    kw.setdefault("seed", 11)
    return make_local_ba_problem(**kw)


def test_segmented_local_ba_matches_monolithic():
    data, state0, _ = _problem(noise_px=0.5)
    res_mono = jax.jit(lambda d, s: local_gp_ba(d, s))(data, state0)
    res_seg, aborted = local_gp_ba_interruptible(data, state0, seg_iters=3)
    assert not aborted
    assert bool(res_mono.ok) == bool(res_seg.ok)
    np.testing.assert_array_equal(
        np.asarray(res_mono.state.T), np.asarray(res_seg.state.T)
    )
    np.testing.assert_array_equal(
        np.asarray(res_mono.state.X), np.asarray(res_seg.state.X)
    )
    np.testing.assert_array_equal(
        np.asarray(res_mono.erase_m), np.asarray(res_seg.erase_m)
    )
    assert float(res_mono.err_final) == float(res_seg.err_final)


def test_segmented_local_ba_matches_monolithic_extrinsic():
    data, state0, _ = _problem(noise_px=0.5, seed=4)
    res_mono = jax.jit(
        lambda d, s: local_gp_ba(d, s, b_extrinsic=True, ext_min_obs=5)
    )(data, state0)
    res_seg, aborted = local_gp_ba_interruptible(
        data, state0, b_extrinsic=True, ext_min_obs=5, seg_iters=4
    )
    assert not aborted
    np.testing.assert_array_equal(
        np.asarray(res_mono.state.T), np.asarray(res_seg.state.T)
    )
    np.testing.assert_array_equal(
        np.asarray(res_mono.state.Text), np.asarray(res_seg.state.Text)
    )
    assert float(res_mono.err_final) == float(res_seg.err_final)


def test_segmented_global_ba_matches_monolithic():
    data, state0, _ = _problem(noise_px=0.5, seed=7)
    s_mono, st_mono = jax.jit(
        lambda d, s: global_ba(d, s, 10), static_argnums=()
    )(data, state0)
    s_seg, st_seg, aborted = global_ba_interruptible(data, state0, 10,
                                                     seg_iters=3)
    assert not aborted
    np.testing.assert_array_equal(np.asarray(s_mono.T), np.asarray(s_seg.T))
    np.testing.assert_array_equal(np.asarray(s_mono.X), np.asarray(s_seg.X))
    assert float(st_mono.chi2) == float(st_seg.chi2)
    assert int(st_mono.iterations) == int(st_seg.iterations)


def test_abort_stops_at_segment_boundary():
    data, state0, _ = _problem(noise_px=0.5, seed=9)
    calls = []

    def abort_after_first_check():
        calls.append(1)
        return True

    state_ab, stats_ab, aborted = global_ba_interruptible(
        data, state0, 10, should_abort=abort_after_first_check, seg_iters=2
    )
    assert aborted
    assert len(calls) == 1
    # stopped after the first 2-iteration segment, not the full schedule
    assert int(stats_ab.iterations) <= 2
    # the partial iterate is still a real improvement (recoverable, as the
    # reference recovers the g2o iterate after a force-stop)
    assert float(stats_ab.chi2) <= float(stats_ab.initial_chi2)

    res, aborted_l = local_gp_ba_interruptible(
        data, state0, should_abort=lambda: True, seg_iters=2
    )
    assert aborted_l
    assert np.isfinite(float(res.err_final))


def _empty_kf(timestamp, Twb, prev):
    from amcslam_tpu.pipeline.map_store import KeyFrame

    kf = KeyFrame(
        timestamp=timestamp,
        cam_times=np.array([timestamp - 0.02, timestamp]),
        Twb=Twb.copy(),
        velocity=np.zeros(6),
        keypoints=[np.zeros((0, 2)), np.zeros((0, 2))],
        kp_octaves=[np.zeros(0, np.int64), np.zeros(0, np.int64)],
        descriptors=[np.zeros((0, 32), np.uint8), np.zeros((0, 32), np.uint8)],
        kp_ur=np.zeros(0),
    )
    kf.prev_kf = prev
    if prev is not None:
        prev.next_kf = kf
    return kf


def _held_gba(monkeypatch):
    """Patch global_ba_interruptible so the worker blocks on `hold` after
    snapshotting — a deterministic stand-in for 'the GBA is still running'."""
    import amcslam_tpu.solver.ba as ba_mod

    started = threading.Event()
    hold = threading.Event()
    real = ba_mod.global_ba_interruptible

    def slow(data, state, num_iterations=10, should_abort=None, seg_iters=2):
        started.set()
        assert hold.wait(60), "test released the hold too late"
        return real(data, state, num_iterations, should_abort=should_abort,
                    seg_iters=seg_iters)

    monkeypatch.setattr(ba_mod, "global_ba_interruptible", slow)
    return started, hold


def test_detached_gba_corrects_keyframe_inserted_mid_solve(monkeypatch):
    """LoopClosing.cc:1266-1330: a KF created while the detached GBA runs is
    absent from the problem; the staged write-back must correct it through
    its prev-chain parent's delta."""
    from amcslam_tpu.pipeline.keyframe_database import KeyFrameDatabase
    from amcslam_tpu.pipeline.loop_closing import LoopClosing

    m, rig, kfs, gt = build_loop_map(n_kf=8, n_lm=60, n_local=15, seed=5)
    lc = LoopClosing(rig, m, KeyFrameDatabase(), detached_gba=True)
    started, hold = _held_gba(monkeypatch)

    lc._launch_global_ba(num_iterations=4)
    assert started.wait(30)
    assert lc.running_gba

    # tracking inserts a keyframe while the GBA is solving
    parent = kfs[-1]
    parent_before = parent.Twb.copy()
    offset = np.eye(4)
    offset[:3, 3] = [0.7, 0.1, 0.0]
    new_kf = _empty_kf(parent.timestamp + 1.0, parent.Twb @ offset, parent)
    with m.mutex:
        m.add_keyframe(new_kf)
    new_before = new_kf.Twb.copy()

    hold.set()
    lc.join_gba(timeout=120)
    assert not lc.running_gba
    assert lc.n_gba_applied == 1 and lc.n_gba_aborted == 0

    # parent was optimized; the mid-solve KF rode its parent's correction
    delta = parent.Twb @ np.linalg.inv(parent_before)
    assert np.linalg.norm(delta - np.eye(4)) > 1e-8, "GBA moved nothing"
    np.testing.assert_allclose(new_kf.Twb, delta @ new_before, atol=1e-9)


def test_detached_gba_superseded_discards_result(monkeypatch):
    """LoopClosing.cc:1245-1249: if mnFullBAIdx moved on while the GBA ran,
    its result is discarded untouched."""
    from amcslam_tpu.pipeline.keyframe_database import KeyFrameDatabase
    from amcslam_tpu.pipeline.loop_closing import LoopClosing

    m, rig, kfs, gt = build_loop_map(n_kf=8, n_lm=60, n_local=15, seed=6)
    lc = LoopClosing(rig, m, KeyFrameDatabase(), detached_gba=True)
    started, hold = _held_gba(monkeypatch)

    poses_before = {k.id: k.Twb.copy() for k in kfs}
    lc._launch_global_ba(num_iterations=4)
    assert started.wait(30)

    # a newer loop closure aborts + supersedes the running GBA
    with lc._gba_lock:
        lc.gba_abort.set()
        lc.full_ba_idx += 1

    hold.set()
    lc.join_gba(timeout=120)
    assert lc.n_gba_applied == 0
    assert lc.n_gba_aborted == 1
    for k in kfs:
        np.testing.assert_array_equal(k.Twb, poses_before[k.id])


def test_local_mapper_abort_flag_set_by_insert():
    """InsertKeyFrame -> InterruptBA (LocalMapping.cc:215)."""
    from amcslam_tpu.pipeline.local_mapping import LocalMapping
    from amcslam_tpu.pipeline.map_store import Map

    m, rig, kfs, _ = build_loop_map(n_kf=4, n_lm=30, n_local=10, seed=8)
    mapper = LocalMapping(rig, m, interruptible=True)
    assert not mapper.abort_ba.is_set()
    mapper.insert_keyframe(kfs[-1])
    assert mapper.abort_ba.is_set()
    # run_once clears the flag after triangulation (LocalMapping.cc:104)
    mapper.run_once()
    assert not mapper.abort_ba.is_set()
