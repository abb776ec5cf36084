"""Batched maximum-likelihood PnP + RANSAC (rebuild of src/MLPnPsolver.cpp).

The reference vendors Urban et al.'s MLPnP (OpenGV): bearing-vector nullspace
formulation — each unit bearing v_i gets a tangent basis (r_i, s_i) and
contributes the linear constraints r_i^T (R p_i + t) = 0, s_i^T (R p_i + t)=0
— solved by SVD over the 12 unknowns [vec(R); t], followed by Gauss-Newton
refinement (`computePose` MLPnPsolver.cpp:356, `mlpnp_gn` :694) inside a
RANSAC loop (`iterate` :100). Dormant in the fork (Relocalization is a stub,
Tracking.cc:1431-1450) but required for relocalization parity.

Device design: hypotheses are a vmapped axis; the DLT is a batched (2n x 12)
SVD; the GN refinement is a fixed-iteration manifold Gauss-Newton on SE(3);
inlier counting is one batched reprojection.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import lie
from ..ops.precision import exact


def _nullspace_basis(v: jax.Array):
    """Tangent basis (r, s) orthogonal to a unit bearing v."""
    # pick the axis least aligned with v for numerical stability
    ref = jnp.where(
        jnp.abs(v[0]) < 0.9,
        jnp.asarray([1.0, 0.0, 0.0], v.dtype),
        jnp.asarray([0.0, 1.0, 0.0], v.dtype),
    )
    r = jnp.cross(v, ref)
    r = r / jnp.linalg.norm(r)
    s = jnp.cross(v, r)
    return r, s


@exact
def mlpnp_dlt(points: jax.Array, bearings: jax.Array):
    """Closed-form (R, t) from n >= 6 correspondences via the nullspace DLT.

    points: (n,3) world points, bearings: (n,3) unit bearing vectors in the
    camera frame. Returns (R (3,3), t (3,)).
    """
    dtype = points.dtype

    def rows(p, v):
        r, s = _nullspace_basis(v)
        # row for unknowns [vec(R) (column-major), t]:
        # r^T R p = (p kron r)^T vec(R)
        row_r = jnp.concatenate([jnp.kron(p, r), r])
        row_s = jnp.concatenate([jnp.kron(p, s), s])
        return jnp.stack([row_r, row_s])

    A = jax.vmap(rows)(points, bearings).reshape(-1, 12)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    x = Vt[-1]
    # x[:9] is vec(R) in column-major order (see the kron rows above)
    R_raw = x[:9].reshape(3, 3).T
    t_raw = x[9:]
    # sign: depths along bearings must be positive for the majority
    depths = jnp.einsum("ni,ni->n", bearings, points @ R_raw.T + t_raw)
    flip = jnp.sum(depths < 0) > points.shape[0] // 2
    R_raw = jnp.where(flip, -R_raw, R_raw)
    t_raw = jnp.where(flip, -t_raw, t_raw)
    # project to SO(3) and rescale t by the mean singular value
    U, w, Vt2 = jnp.linalg.svd(R_raw)
    d = jnp.linalg.det(U @ Vt2)
    D = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], dtype)).at[2, 2].set(d)
    R = U @ D @ Vt2
    scale = jnp.mean(w)
    t = t_raw / jnp.maximum(scale, 1e-12)
    return R, t


def mlpnp_gn(R, t, points, bearings, weights, n_iters: int = 5):
    """Gauss-Newton refinement of the nullspace residuals on SE(3).

    Minimizes sum_i w_i || [r_i; s_i]^T (R p_i + t) / z_i ||^2 with a right-
    multiplicative retraction (mlpnp_gn, MLPnPsolver.cpp:694ff).
    """
    dtype = points.dtype
    T0 = lie.se3_matrix(R, t)
    basis = jax.vmap(_nullspace_basis)(bearings)

    def residuals(T):
        def one(p, v, r, s, w):
            Xc = lie.transform_point(T, p)
            n = jnp.maximum(jnp.linalg.norm(Xc), 1e-12)
            return jnp.stack([jnp.dot(r, Xc), jnp.dot(s, Xc)]) / n * jnp.sqrt(w)

        return jax.vmap(one)(points, bearings, basis[0], basis[1], weights)

    def body(_, T):
        def r_of(d):
            return residuals(T @ lie.exp_se3(d)).ravel()

        z = jnp.zeros(6, dtype)
        r = r_of(z)
        J = jax.jacfwd(r_of)(z)
        H = J.T @ J + 1e-9 * jnp.eye(6, dtype=dtype)
        dx = -jnp.linalg.solve(H, J.T @ r)
        return T @ lie.exp_se3(dx)

    T = lax.fori_loop(0, n_iters, body, T0)
    return T[:3, :3], T[:3, 3]


class PnPRansacData(NamedTuple):
    points: jax.Array    # (N,3) world points
    bearings: jax.Array  # (N,3) unit bearings (camera frame)
    obs: jax.Array       # (N,2) pixel observations (for inlier check)
    K: jax.Array         # (4,) pinhole intrinsics
    w: jax.Array         # (N,) weights (invSigma2)
    valid: jax.Array     # (N,) bool
    th2: jax.Array       # (N,) per-point squared pixel threshold


def pnp_ransac(data: PnPRansacData, samples: jax.Array, refine_iters: int = 5):
    """All-hypotheses-parallel MLPnP RANSAC. samples: (H,6) int32.

    Returns ((R, t) camera-from-world of the best hypothesis, inlier mask,
    count). Matches MLPnPsolver::iterate's structure: minimal solve + GN +
    reprojection gating.
    """

    def reproj_inliers(R, t):
        def one(p, obs, th2):
            Xc = R @ p + t
            u = data.K[0] * Xc[0] / Xc[2] + data.K[2]
            v = data.K[1] * Xc[1] / Xc[2] + data.K[3]
            e = (u - obs[0]) ** 2 + (v - obs[1]) ** 2
            return (e < th2) & (Xc[2] > 0)

        return jax.vmap(one)(data.points, data.obs, data.th2) & data.valid

    def hypo(idx):
        R, t = mlpnp_dlt(data.points[idx], data.bearings[idx])
        R, t = mlpnp_gn(R, t, data.points[idx], data.bearings[idx],
                        data.w[idx], refine_iters)
        inl = reproj_inliers(R, t)
        return R, t, inl, jnp.sum(inl)

    R_h, t_h, inl_h, n_h = jax.vmap(hypo)(samples)
    best = jnp.argmax(n_h)
    return (R_h[best], t_h[best]), inl_h[best], n_h[best]
