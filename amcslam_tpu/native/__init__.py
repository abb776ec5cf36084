"""Native (C++) host-runtime components.

Compiled lazily with the in-image toolchain on first import; falls back to
the pure-Python paths when a compiler is unavailable (`available()` gates).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import subprocess
import sysconfig

import numpy as np

_mods: dict = {}


def _host_cpu_id() -> bytes:
    """The host CPU's model and feature flags (what -march=native targets)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f if ln.startswith((b"model name", b"flags"))]
        return b"".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


def _build_and_load(name: str = "graph_builder"):
    """Compile + import one of the extension sources in this directory.
    Cache keyed on a hash of the source and the host CPU, and on the
    Python/ABI/platform tag via EXT_SUFFIX, so a binary built with
    -march=native on another host or Python is never reused (it would
    SIGILL or fail to import), even in a copied tree. Artifacts are
    gitignored."""
    if name in _mods:
        return _mods[name]
    _mods[name] = None
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, f"{name}.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + _host_cpu_id()).hexdigest()[:12]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(here, f"_{name}_{tag}" + suffix)
    if not os.path.exists(out):
        # compile to a process-private temp name and rename into place:
        # rename is atomic within a directory, so a concurrent process (e.g.
        # pytest racing bench) never imports a partially written artifact
        include = sysconfig.get_paths()["include"]
        tmp = out + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            f"-I{include}", src, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
            os.replace(tmp, out)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    try:
        spec = importlib.util.spec_from_file_location(f"_{name}", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mods[name] = mod
    except ImportError:
        _mods[name] = None
    return _mods[name]


def _require(name: str = "graph_builder"):
    mod = _build_and_load(name)
    if mod is None:
        raise RuntimeError(
            f"amcslam_tpu.native: C++ extension {name!r} unavailable (no "
            "toolchain or build failed); gate calls with native.available()"
        )
    return mod


def available(name: str = "graph_builder") -> bool:
    return _build_and_load(name) is not None


def orb_extract(img: np.ndarray, n_levels: int, scale_factor: float,
                ini_th: int, min_th: int, budgets: np.ndarray,
                pattern: np.ndarray, patch_off: np.ndarray):
    """Native full-pyramid ORB extraction (see orb_fast.cpp). Returns
    (xy (N,2) float64 level-0 px, octave (N,) int32, desc (N,32) uint8,
    angle (N,) float64)."""
    mod = _require("orb_fast")
    xy_b, oc_b, de_b, an_b = mod.extract(
        np.ascontiguousarray(img, np.uint8), int(n_levels),
        float(scale_factor), int(ini_th), int(min_th),
        np.ascontiguousarray(budgets, np.int32),
        np.ascontiguousarray(pattern, np.int32),
        np.ascontiguousarray(patch_off, np.int32),
    )
    xy = np.frombuffer(xy_b, np.float64).reshape(-1, 2).copy()
    oc = np.frombuffer(oc_b, np.int32).astype(np.int64)
    de = np.frombuffer(de_b, np.uint8).reshape(-1, 32).copy()
    an = np.frombuffer(an_b, np.float64).copy()
    return xy, oc, de, an


def build_obs_edges(matches, kf_of_kp, cam_of_kp, prev_slot,
                    lm_keys, lm_vals, stereo_cam: int):
    """Native observation-edge extraction. Returns (mono (Em,5), stereo (Es,3))
    float64 arrays with rows [i, j, lm, cam, kp_index] / [pose, lm, kp_index]."""
    mod = _require()
    mono_b, st_b = mod.build_obs_edges(
        np.ascontiguousarray(matches, np.int64),
        np.ascontiguousarray(kf_of_kp, np.int32),
        np.ascontiguousarray(cam_of_kp, np.int32),
        np.ascontiguousarray(prev_slot, np.int32),
        np.ascontiguousarray(lm_keys, np.int64),
        np.ascontiguousarray(lm_vals, np.int32),
        int(stereo_cam),
    )
    mono = np.frombuffer(mono_b, np.float64).reshape(-1, 5)
    st = np.frombuffer(st_b, np.float64).reshape(-1, 3)
    return mono, st


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Native popcount Hamming table for (N,32)x(M,32) uint8 descriptors."""
    mod = _require()
    out = mod.hamming_matrix(
        np.ascontiguousarray(a, np.uint8), np.ascontiguousarray(b, np.uint8)
    )
    return np.frombuffer(out, np.int32).reshape(len(a), len(b)).copy()


def match_window(u, v, valid, r_pt, lvl_lo, lvl_hi, ur_pred, mp_desc,
                 kp_u, kp_v, kp_oct, kp_r, kp_ur, kp_desc,
                 max_dist: int, ratio: float = 0.0,
                 use_pt_radius: bool = True, use_ur: bool = False):
    """Projection-window descriptor matching over a sorted-u keypoint index
    (the native form of the ORBmatcher SearchByProjection window walks).
    Returns (best_j (M,) int64 with -1 for none, best_d (M,) int32)."""
    mod = _require()
    f32c = lambda x: np.ascontiguousarray(x, np.float32)
    i32c = lambda x: np.ascontiguousarray(x, np.int32)
    bj_b, bd_b = mod.match_window(
        f32c(u), f32c(v), np.ascontiguousarray(valid, np.uint8), f32c(r_pt),
        i32c(lvl_lo), i32c(lvl_hi), f32c(ur_pred),
        np.ascontiguousarray(mp_desc, np.uint8),
        f32c(kp_u), f32c(kp_v), i32c(kp_oct), f32c(kp_r), f32c(kp_ur),
        np.ascontiguousarray(kp_desc, np.uint8),
        int(max_dist), float(ratio), int(use_pt_radius), int(use_ur),
    )
    bj = np.frombuffer(bj_b, np.int32).astype(np.int64)
    bd = np.frombuffer(bd_b, np.int32).copy()
    return bj, bd


def hamming_best(a: np.ndarray, b: np.ndarray):
    """Fused nearest/second-nearest Hamming reduction: for each row of `a`,
    the index + distance of its closest descriptor in `b` and the
    second-closest distance — O(N+M) memory, threaded over rows, never
    materializing the (N,M) table. Returns (best_j, best_d, second_d)."""
    mod = _require()
    bj_b, bd_b, sd_b = mod.hamming_best(
        np.ascontiguousarray(a, np.uint8), np.ascontiguousarray(b, np.uint8)
    )
    bj = np.frombuffer(bj_b, np.int32).astype(np.int64)
    bd = np.frombuffer(bd_b, np.int32).copy()
    sd = np.frombuffer(sd_b, np.int32).copy()
    return bj, bd, sd
