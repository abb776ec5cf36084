"""Batched Horn Sim3 solver + RANSAC (rebuild of src/Sim3Solver.cc).

The reference iterates serial RANSAC hypotheses (Sim3Solver::iterate,
Sim3Solver.cc:181-342), each: Horn's closed-form similarity from 3 point
pairs (ComputeSim3, :343-464) + reprojection inlier check through each
keyframe's multi-camera rig (CheckInliers, :466-500). Here ALL
hypotheses evaluate in parallel — one vmapped Horn solve (batched 4x4
symmetric eigendecomposition on device) and one batched inlier count.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..factors.reprojection import project_pinhole
from ..ops import lie
from ..ops.precision import exact


@exact
def horn_sim3(P1: jax.Array, P2: jax.Array, fix_scale) -> tuple:
    """Closed-form similarity S12 = (s, R, t) aligning P2 -> P1.

    P1, P2: (N,3) corresponding points (N >= 3). Horn 1987 quaternion method:
    M = Pr2^T-cross-covariance, 4x4 N-matrix, principal eigenvector =
    rotation quaternion; s = <Pr1, R Pr2> / ||R Pr2||^2 (or 1 when the scale
    is fixed); t = O1 - s R O2. Mirrors ComputeSim3 (Sim3Solver.cc:343-464).
    """
    dtype = P1.dtype
    O1 = jnp.mean(P1, axis=0)
    O2 = jnp.mean(P2, axis=0)
    Pr1 = (P1 - O1).T  # (3,N)
    Pr2 = (P2 - O2).T

    M = Pr2 @ Pr1.T
    N11 = M[0, 0] + M[1, 1] + M[2, 2]
    N12 = M[1, 2] - M[2, 1]
    N13 = M[2, 0] - M[0, 2]
    N14 = M[0, 1] - M[1, 0]
    N22 = M[0, 0] - M[1, 1] - M[2, 2]
    N23 = M[0, 1] + M[1, 0]
    N24 = M[2, 0] + M[0, 2]
    N33 = -M[0, 0] + M[1, 1] - M[2, 2]
    N34 = M[1, 2] + M[2, 1]
    N44 = -M[0, 0] - M[1, 1] + M[2, 2]
    N = jnp.asarray(
        [
            [N11, N12, N13, N14],
            [N12, N22, N23, N24],
            [N13, N23, N33, N34],
            [N14, N24, N34, N44],
        ],
        dtype=dtype,
    )
    evals, evecs = jnp.linalg.eigh(N)  # ascending; principal = last column
    q = evecs[:, -1]  # (w, x, y, z)
    vec = q[1:]
    nv = jnp.linalg.norm(vec)
    ang = jnp.arctan2(nv, q[0])
    axis = jnp.where(nv > 1e-7, 2.0 * ang * vec / jnp.maximum(nv, 1e-12), jnp.zeros(3, dtype))
    R = lie.exp_so3(axis)

    P3 = R @ Pr2
    nom = jnp.sum(Pr1 * P3)
    den = jnp.sum(P3 * P3)
    s = jnp.where(fix_scale, jnp.ones((), dtype), nom / den)
    t = O1 - s * (R @ O2)
    return s, R, t


class Sim3RansacData(NamedTuple):
    """Correspondences between two multi-camera keyframes (SoA)."""

    Xb1: jax.Array        # (N,3) matched points in KF1 body frame
    Xb2: jax.Array        # (N,3) matched points in KF2 body frame
    obs1: jax.Array       # (N,2) image observation in KF1
    obs2: jax.Array       # (N,2) image observation in KF2
    cam1: jax.Array       # (N,) int32 camera index in KF1
    cam2: jax.Array       # (N,) int32
    max_err1: jax.Array   # (N,) 9.21*sigma2 per-point threshold in image 1
    max_err2: jax.Array   # (N,)
    valid: jax.Array      # (N,) bool
    K1: jax.Array         # (C1,4)
    K2: jax.Array         # (C2,4)
    Tc1b: jax.Array       # (C1,4,4) camera-from-body of KF1 cameras
    Tc2b: jax.Array       # (C2,4,4)
    fix_scale: jax.Array  # ()


def _check_inliers(s, R, t, data: Sim3RansacData):
    """Project each match through the hypothesis both ways (CheckInliers)."""

    def one(Xb1, Xb2, obs1, obs2, c1, c2):
        Xb1_from2 = s * (R @ Xb2) + t
        u1 = project_pinhole(
            data.K1[c1], lie.transform_point(data.Tc1b[c1], Xb1_from2)
        )
        Rt = R.T
        Xb2_from1 = (Rt @ (Xb1 - t)) / s
        u2 = project_pinhole(
            data.K2[c2], lie.transform_point(data.Tc2b[c2], Xb2_from1)
        )
        e1 = jnp.sum((obs1 - u1) ** 2)
        e2 = jnp.sum((obs2 - u2) ** 2)
        return e1, e2

    e1, e2 = jax.vmap(one)(
        data.Xb1, data.Xb2, data.obs1, data.obs2, data.cam1, data.cam2
    )
    inlier = data.valid & (e1 < data.max_err1) & (e2 < data.max_err2)
    return inlier


def sim3_ransac(data: Sim3RansacData, samples: jax.Array):
    """All-hypotheses-parallel Sim3 RANSAC.

    samples: (H,3) int32 indices into the correspondence arrays (host-sampled,
    mirroring Sim3Solver::iterate's random triples). Returns
    (best s/R/t, best inlier mask, best count, per-hypothesis counts).
    """

    def hypo(idx):
        P1 = data.Xb1[idx]
        P2 = data.Xb2[idx]
        s, R, t = horn_sim3(P1, P2, data.fix_scale)
        inl = _check_inliers(s, R, t, data)
        return s, R, t, inl, jnp.sum(inl)

    s_h, R_h, t_h, inl_h, n_h = jax.vmap(hypo)(samples)
    best = jnp.argmax(n_h)
    return (
        (s_h[best], R_h[best], t_h[best]),
        inl_h[best],
        n_h[best],
        n_h,
    )
