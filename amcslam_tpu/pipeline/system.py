"""System facade (rebuild of src/System.cc): wiring, per-tick entry point,
trajectory savers, atlas checkpoint/resume.

Threading: the reference spawns LocalMapping / LoopClosing / Viewer threads
(System.cc:165-206). Here the default is a deterministic sequential schedule
(track -> drain mapper -> drain loop closer), with `threaded=True` running
mapper+closer in a background worker — the heavy math is asynchronous on the
device either way (JAX dispatch), so host threads only matter for overlapping
Python bookkeeping.
"""

from __future__ import annotations

import hashlib
import os as _os
import pickle
import threading
from dataclasses import dataclass

import numpy as np

from .keyframe_database import KeyFrameDatabase
from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .map_store import Atlas, Frame
from .rig import Rig
from .tracking import Tracking, TrackingConfig, TrackState


class System:
    def __init__(
        self,
        rig: Rig,
        tracking_config: TrackingConfig | None = None,
        enable_loop_closing: bool = True,
        b_extrinsic: bool = False,
        threaded: bool = False,
    ):
        self.rig = rig
        self.atlas = Atlas()
        self.kfdb = KeyFrameDatabase()
        # threaded mode gets the reference's interruption semantics: a
        # detached abortable global BA (LoopClosing.cc:1036-1044) and the
        # mbAbortBA force-stop on the local BA (LocalMapping.cc:215); the
        # sequential schedule stays synchronous and deterministic.
        self.loop_closer = (
            LoopClosing(rig, self.atlas.active, self.kfdb,
                        detached_gba=threaded)
            if enable_loop_closing
            else None
        )
        self.local_mapper = LocalMapping(
            rig, self.atlas.active, b_extrinsic=b_extrinsic,
            loop_closer=self.loop_closer, interruptible=threaded,
        )
        self.tracker = Tracking(
            rig, self.atlas, tracking_config, local_mapper=self.local_mapper,
            kfdb=self.kfdb,
        )
        self.threaded = threaded
        self._stop = False
        # Seed the shape buckets at serving sizes so each jitted solver
        # program compiles ONCE (steady-state shapes) instead of stepping
        # through warmup generations as the map grows — each step is a
        # fresh 30-60 s XLA:CPU trace+compile. Opt out to get tight-fit
        # shapes (tiny problems on memory-constrained hosts).
        if not _os.environ.get("AMCSLAM_NO_BUCKET_PRESET"):
            from .extraction import preset_shape_buckets

            preset_shape_buckets()
        # Long CPU-backend runs accumulate one compiled executable per
        # program shape; each holds several mmap regions of JIT-compiled
        # host code, and the default vm.max_map_count kills
        # multi-hundred-compile runs ("Cannot allocate memory" from LLVM
        # with free RAM).  Dropping the live executables every N keyframes
        # bounds the map count; the persistent compilation cache makes the
        # re-loads cheap.  GPU executables keep their code on the device:
        # the AMV-rig and loop-course runs of chip_smoke.py grew
        # /proc/self/maps from 1201 to 1256 lines on an H100, so only the
        # CPU backend clears by default (0 = off).
        self.clear_caches_every = int(
            _os.environ.get("AMCSLAM_CLEAR_CACHES_EVERY", "0") or 0
        )
        if self.clear_caches_every == 0:
            try:
                import jax

                if jax.default_backend() == "cpu":
                    self.clear_caches_every = 64
            except Exception:
                pass
        self._kf_at_last_clear = 0
        if threaded:
            self._worker = threading.Thread(target=self._background, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def track_multicamera(self, frame: Frame) -> TrackState:
        """System::TrackMultiCamera -> Tracking::GrabImageMultiCam.

        Threaded mode serializes tracking against the background
        mapper/loop-closer through the active map's `mutex` (the
        reference's mMutexMapUpdate, Map.h / Tracking.cc:1096)."""
        with self.atlas.active.mutex:
            state = self.tracker.grab_frame(frame)
        if not self.threaded:
            while self.local_mapper.run_once():
                pass
            if self.loop_closer is not None:
                while self.loop_closer.run_once():
                    pass
            self._maybe_clear_caches()
        return state

    def _maybe_clear_caches(self):
        if self.clear_caches_every <= 0:
            return
        n_kf = len(self.atlas.active.keyframes)
        if n_kf - self._kf_at_last_clear >= self.clear_caches_every:
            import jax

            jax.clear_caches()
            self._kf_at_last_clear = n_kf

    def _background(self):
        import time

        while not self._stop:
            m = self.atlas.active
            # per-stage locking: the mapper takes the map mutex around each
            # map-mutating stage but releases it for the local-BA solve, so
            # tracking is never blocked for a multi-second device solve
            busy = self.local_mapper.run_once(lock=m.mutex)
            if self.loop_closer is not None:
                with m.mutex:
                    busy = self.loop_closer.run_once() or busy
            if not busy:
                time.sleep(0.002)

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode: tracking only, map frozen."""
        self.tracker.cfg.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.cfg.localization_only = False

    def shutdown(self):
        self._stop = True
        if self.threaded:
            self._worker.join(timeout=5)
        if self.loop_closer is not None:
            self.loop_closer.join_gba(timeout=600)

    # ------------------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        """SaveTrajectoryTUM (System.cc:393-460): recompose each frame's
        RELATIVE pose against its reference keyframe's current (loop-/GBA-
        corrected) pose; frames flagged lost are skipped (System.cc:400)."""
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for t, Twb in self.tracker.trajectory_poses():
                q = Rotation.from_matrix(Twb[:3, :3]).as_quat()  # x y z w
                p = Twb[:3, 3]
                f.write(
                    f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_keyframe_trajectory_tum(self, path: str):
        from scipy.spatial.transform import Rotation

        kfs = sorted(self.atlas.active.keyframes.values(), key=lambda k: k.timestamp)
        with open(path, "w") as f:
            for k in kfs:
                q = Rotation.from_matrix(k.Twb[:3, :3]).as_quat()
                p = k.Twb[:3, 3]
                f.write(
                    f"{k.timestamp:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_trajectory_euroc(self, path: str):
        """SaveTrajectoryEuRoC (System.cc:481-680): same loop-consistent
        recomposition as TUM, EuRoC convention — timestamps in nanoseconds,
        poses from the map with the most keyframes."""
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for t, Twb in self.tracker.trajectory_poses():
                q = Rotation.from_matrix(Twb[:3, :3]).as_quat()
                p = Twb[:3, 3]
                f.write(
                    f"{t * 1e9:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
                )

    def save_keyframe_trajectory_euroc(self, path: str):
        """SaveKeyFrameTrajectoryEuRoC (System.cc:850-897): keyframe poses
        of the biggest map, nanosecond timestamps."""
        from scipy.spatial.transform import Rotation

        maps = getattr(self.atlas, "maps", None) or [self.atlas.active]
        biggest = max(maps, key=lambda m: len(m.keyframes))
        kfs = sorted(biggest.keyframes.values(), key=lambda k: k.timestamp)
        with open(path, "w") as f:
            for k in kfs:
                if k.bad:
                    continue
                q = Rotation.from_matrix(k.Twb[:3, :3]).as_quat()
                p = k.Twb[:3, 3]
                f.write(
                    f"{k.timestamp * 1e9:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """SaveTrajectoryKITTI (System.cc:969-1020): per-frame 3x4 row-major
        pose matrices, re-expressed so the FIRST keyframe sits at the origin
        (after a loop closure it may not), frames recomposed against the
        corrected keyframe poses exactly as the TUM saver."""
        kfs = sorted(self.atlas.active.keyframes.values(), key=lambda k: k.id)
        T0 = kfs[0].Twb if kfs else np.eye(4)
        T0_inv = np.linalg.inv(T0)
        with open(path, "w") as f:
            for _, Twb in self.tracker.trajectory_poses():
                M = T0_inv @ Twb
                f.write(
                    " ".join(f"{M[r, c]:.9f}" for r in range(3) for c in range(4))
                    + "\n"
                )

    # ------------------------------------------------------------------
    def save_atlas(self, path: str):
        """SaveAtlas with md5 checksum (System.h:194-197, CalculateCheckSum)."""
        payload = pickle.dumps(
            {"atlas": self.atlas, "trajectory": self.tracker.trajectory}
        )
        digest = hashlib.md5(payload).hexdigest()
        with open(path, "wb") as f:
            pickle.dump({"md5": digest, "payload": payload}, f)

    def load_atlas(self, path: str):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if hashlib.md5(blob["payload"]).hexdigest() != blob["md5"]:
            raise IOError("atlas checksum mismatch")
        state = pickle.loads(blob["payload"])
        self.atlas = state["atlas"]
        self.tracker.atlas = self.atlas
        self.tracker.trajectory = state["trajectory"]
        self.local_mapper.map = self.atlas.active
        if self.loop_closer is not None:
            self.loop_closer.map = self.atlas.active
        # rebuild the retrieval database (PostLoad id remapping analog)
        self.kfdb = KeyFrameDatabase()
        for kf in self.atlas.active.keyframes.values():
            self.kfdb.add(kf)
        if self.loop_closer is not None:
            self.loop_closer.kfdb = self.kfdb

    def reset_active_map(self):
        """ResetActiveMap chain (System.h:129-131)."""
        self.atlas.create_new_map()
        self.tracker.state = TrackState.NOT_INITIALIZED
        self.tracker.last_kf = None
        self.local_mapper.map = self.atlas.active
        self.local_mapper.queue.clear()
        self.local_mapper.recent_points.clear()
        if self.loop_closer is not None:
            self.loop_closer.map = self.atlas.active
            self.loop_closer.queue.clear()
