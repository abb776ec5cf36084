"""Configuration loading (rebuild of Settings.cc + the Tracking parse methods).

Reads the reference's three-tier config: the run YAML (Camera.number, dataset
paths, Gaussian.Qc diag, Velocity prior, Ransac.threshold, ORB params,
Extrinsic, loopClosing, thFarPoints — orb_multicam.yaml:1-33) and per-camera
JSON calibration files (`sensor_to_vehicle` 4x4 -> Tbc, `intrinsics` 3x3 ->
K; Tracking.cc:681-734). Emits a Rig + TrackingConfig + system flags.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .rig import Rig
from .tracking import TrackingConfig


@dataclass
class SystemConfig:
    rig: Rig
    tracking: TrackingConfig
    loop_closing: bool = True
    extrinsic_refine: bool = False
    dataset_path: str = ""
    n_features: int = 1200
    th_far_points: float = 0.0


def load_camera_json(path: str):
    """Per-camera JSON: sensor_to_vehicle (Tbc), intrinsics (K)."""
    with open(path) as f:
        d = json.load(f)
    Tbc = np.asarray(d["sensor_to_vehicle"], float).reshape(4, 4)
    Km = np.asarray(d["intrinsics"], float).reshape(3, 3)
    K4 = np.array([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]])
    return Tbc, K4


def load_config(yaml_path: str) -> SystemConfig:
    import yaml

    with open(yaml_path) as f:
        text = f.read()
    # tolerate OpenCV FileStorage headers ("%YAML:1.0")
    text = text.replace("%YAML:1.0", "").replace("---", "", 1)
    cfg = yaml.safe_load(text) or {}

    n_cams = int(cfg.get("Camera.number", cfg.get("Camera", {}).get("number", 2)))
    base = os.path.dirname(os.path.abspath(yaml_path))

    Tbcs, Ks = [], []
    cam_files = cfg.get("Camera.calibfiles", [])
    if cam_files:
        for cf in cam_files:
            Tbc, K4 = load_camera_json(os.path.join(base, cf))
            Tbcs.append(Tbc)
            Ks.append(K4)
    else:
        # flat-key fallback: Camera.fx etc. for a single-model rig
        fx = float(cfg.get("Camera.fx", 420.0))
        fy = float(cfg.get("Camera.fy", fx))
        cx = float(cfg.get("Camera.cx", 480.0))
        cy = float(cfg.get("Camera.cy", 300.0))
        for _ in range(n_cams):
            Tbcs.append(np.eye(4))
            Ks.append(np.array([fx, fy, cx, cy]))

    qc = cfg.get("Gaussian.Qc", [1.0] * 6)
    if np.isscalar(qc):
        qc = [float(qc)] * 6
    ini_vel = np.asarray(cfg.get("Velocity", [0.0] * 6), float)

    rig = Rig(
        Tbc=np.stack(Tbcs),
        K=np.stack(Ks),
        bf=float(cfg.get("Camera.bf", 40.0)),
        qc_diag=np.asarray(qc, float),
        ini_vel=ini_vel,
        scale_factor=float(cfg.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(cfg.get("ORBextractor.nLevels", 8)),
    )
    tracking = TrackingConfig(
        ransac_threshold=float(cfg.get("Ransac.threshold", 3.0)),
    )
    return SystemConfig(
        rig=rig,
        tracking=tracking,
        loop_closing=bool(cfg.get("loopClosing", 1)),
        extrinsic_refine=bool(cfg.get("Extrinsic", 0)),
        dataset_path=str(cfg.get("dataset", "")),
        n_features=int(cfg.get("ORBextractor.nFeatures", 1200)),
        th_far_points=float(cfg.get("thFarPoints", 0.0)),
    )
