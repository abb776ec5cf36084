"""Batched SO(3)/SE(3) Lie-group kernels (pure JAX, vmap-first).

This is the L1 geometry substrate of the framework: the batched JAX
equivalent of the reference's Sophus usage plus `src/Pose3utils.cc`
(SE(3) left/right Jacobians with Barfoot's closed-form Q coupling block,
`se3Adj`, `CircleDot`) and the SO(3) helpers in `src/G2oTypes.cc:513-597`.

Conventions (match Sophus, used throughout the reference):
  * se(3) tangent vectors are ``xi = [rho, omega]`` — translation first.
  * SE(3) elements are 4x4 homogeneous matrices ``T`` with ``T[:3,:3] = R``.
  * ``exp``/``log`` are the matrix exponential/logarithm; retractions are
    right-multiplicative: ``T <- T @ exp_se3(delta)``.

All functions are written for unbatched inputs and are `vmap`-compatible;
every branch is expressed with `jnp.where` over Taylor-series fallbacks so
that gradients are NaN-free at the identity. Small-angle thresholds are
dtype-aware: closed forms suffer catastrophic cancellation in float32 far
earlier than in float64, so the series (carried to theta^4, giving
O(theta^6) truncation error) takes over sooner there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .precision import exact, smm


def _small_threshold2(dtype) -> float:
    """Squared angle below which Taylor series replace closed forms."""
    if jnp.dtype(dtype) == jnp.float64:
        return 1e-4  # theta < 1e-2
    return 4e-2  # theta < 0.2


def hat(w: jax.Array) -> jax.Array:
    """3-vector -> 3x3 skew-symmetric matrix (so(3) hat operator)."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy]),
            jnp.stack([wz, z, -wx]),
            jnp.stack([-wy, wx, z]),
        ]
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def _trig_coeffs(theta2: jax.Array):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), series-safe.

    Each coefficient is evaluated with its closed form for large angles and
    a theta^4 Taylor series near zero.
    """
    dt = theta2.dtype
    small = theta2 < _small_threshold2(dt)
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe2)
    s, c = jnp.sin(theta), jnp.cos(theta)
    t4 = theta2 * theta2
    A = jnp.where(small, 1.0 - theta2 / 6.0 + t4 / 120.0, s / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0 + t4 / 720.0, (1.0 - c) / safe2)
    C = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0, (theta - s) / (safe2 * theta)
    )
    return A, B, C


@exact
def exp_so3(w: jax.Array) -> jax.Array:
    """so(3) exponential map (Rodrigues), series-safe at the identity."""
    theta2 = jnp.dot(w, w)
    A, B, _ = _trig_coeffs(theta2)
    W = hat(w)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + A * W + B * smm(W, W)


def quat_from_rotmat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion [w, x, y, z] (branchless Shepperd).

    All four extraction candidates are computed and the numerically best one
    (largest pivot) is selected with `where`, so the function is vmap- and
    grad-safe for any rotation including angles near pi.
    """
    dt = R.dtype
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    one = jnp.ones((), dtype=dt)

    # Candidate pivots: 1+tr, 1+2*m00-tr, 1+2*m11-tr, 1+2*m22-tr (all = 4w^2 etc.)
    p0 = 1.0 + tr
    p1 = 1.0 + 2.0 * m00 - tr
    p2 = 1.0 + 2.0 * m11 - tr
    p3 = 1.0 + 2.0 * m22 - tr
    pivots = jnp.stack([p0, p1, p2, p3])
    idx = jnp.argmax(pivots)
    safe = jnp.sqrt(jnp.maximum(pivots, jnp.finfo(dt).tiny))

    # q = [w,x,y,z] for each pivot choice (unnormalized; scale 0.5/sqrt(p))
    q0 = jnp.stack([p0, m21 - m12, m02 - m20, m10 - m01]) / (2.0 * safe[0])
    q1 = jnp.stack([m21 - m12, p1, m01 + m10, m02 + m20]) / (2.0 * safe[1])
    q2 = jnp.stack([m02 - m20, m01 + m10, p2, m12 + m21]) / (2.0 * safe[2])
    q3 = jnp.stack([m10 - m01, m02 + m20, m12 + m21, p3]) / (2.0 * safe[3])
    qs = jnp.stack([q0, q1, q2, q3])
    q = qs[idx]
    q = q / jnp.linalg.norm(q)
    # Canonicalize to w >= 0 so log gives the short geodesic.
    q = jnp.where(q[0] < 0, -q, q) * one
    return q


@exact
def log_so3(R: jax.Array) -> jax.Array:
    """SO(3) logarithm via quaternion extraction (robust up to theta = pi)."""
    q = quat_from_rotmat(R)
    w, v = q[0], q[1:]
    nv2 = jnp.dot(v, v)
    small = nv2 < _small_threshold2(R.dtype) * 0.25
    nv = jnp.sqrt(jnp.where(small, jnp.ones_like(nv2), nv2))
    # theta = 2*atan2(|v|, w);   omega = theta * v / |v|
    # Series of 2*atan2(|v|, w)/|v| around |v|=0 (w ~ 1): 2/w * (1 - nv2/(3 w^2))
    w_safe = jnp.maximum(w, jnp.asarray(1e-3, R.dtype))  # w>=cos(pi/2)=0 always; >0.7 when small
    factor = jnp.where(
        small,
        2.0 / w_safe * (1.0 - nv2 / (3.0 * w_safe * w_safe)),
        2.0 * jnp.arctan2(nv, w) / nv,
    )
    return factor * v


@exact
def left_jacobian_so3(w: jax.Array) -> jax.Array:
    """SO(3) left Jacobian Jl(w) = I + B*hat(w) + C*hat(w)^2.

    Mirrors `LeftJacobianRot3` (Pose3utils.cc:48-60) in hat-squared form.
    """
    theta2 = jnp.dot(w, w)
    _, B, C = _trig_coeffs(theta2)
    W = hat(w)
    return jnp.eye(3, dtype=w.dtype) + B * W + C * smm(W, W)


@exact
def left_jacobian_so3_inv(w: jax.Array) -> jax.Array:
    """Inverse SO(3) left Jacobian, Jl^{-1} = I - hat/2 + D*hat^2.

    D = 1/theta^2 - (1 + cos)/(2 theta sin); series 1/12 + t^2/720 + t^4/30240.
    Mirrors `LeftJacobianRot3Inv` (Pose3utils.cc:61-73).
    """
    theta2 = jnp.dot(w, w)
    dt = theta2.dtype
    small = theta2 < _small_threshold2(dt)
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe2)
    s, c = jnp.sin(theta), jnp.cos(theta)
    t4 = theta2 * theta2
    D = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0,
        1.0 / safe2 - (1.0 + c) / (2.0 * theta * s),
    )
    W = hat(w)
    return jnp.eye(3, dtype=w.dtype) - 0.5 * W + D * smm(W, W)


def right_jacobian_so3(w: jax.Array) -> jax.Array:
    """SO(3) right Jacobian Jr(w) = Jl(-w) (G2oTypes.cc RightJacobianSO3)."""
    return left_jacobian_so3(-w)


def right_jacobian_so3_inv(w: jax.Array) -> jax.Array:
    return left_jacobian_so3_inv(-w)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3_matrix(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble 4x4 homogeneous transform from rotation + translation.

    Built with concatenation, never `.at[].set` — vmapped index-updates
    lower to per-element scatters; concatenate is a plain copy.
    """
    top = jnp.concatenate([R, t[:, None]], axis=1)
    bottom = jnp.concatenate(
        [jnp.zeros((1, 3), R.dtype), jnp.ones((1, 1), R.dtype)], axis=1
    )
    return jnp.concatenate([top, bottom], axis=0)


@exact
def se3_inv(T: jax.Array) -> jax.Array:
    """Inverse of a rigid transform without a general 4x4 inverse."""
    R = T[:3, :3]
    t = T[:3, 3]
    return se3_matrix(R.T, -smm(R.T, t))


@exact
def exp_se3(xi: jax.Array) -> jax.Array:
    """se(3) exponential, xi = [rho, omega] -> 4x4 transform."""
    rho, w = xi[:3], xi[3:]
    R = exp_so3(w)
    t = smm(left_jacobian_so3(w), rho)
    return se3_matrix(R, t)


@exact
def log_se3(T: jax.Array) -> jax.Array:
    """SE(3) logarithm -> [rho, omega]."""
    w = log_so3(T[:3, :3])
    rho = smm(left_jacobian_so3_inv(w), T[:3, 3])
    return jnp.concatenate([rho, w])


@exact
def adj_se3(T: jax.Array) -> jax.Array:
    """Adjoint of SE(3) for [rho, omega] tangents: [[R, hat(t)R],[0, R]]."""
    R = T[:3, :3]
    t = T[:3, 3]
    Z = jnp.zeros((3, 3), T.dtype)
    return jnp.concatenate(
        [
            jnp.concatenate([R, smm(hat(t), R)], axis=1),
            jnp.concatenate([Z, R], axis=1),
        ],
        axis=0,
    )


def se3_ad(v: jax.Array) -> jax.Array:
    """Adjoint of an se(3) element, ad(v) = [[hat(w), hat(rho)],[0, hat(w)]].

    Mirrors `se3Adj` (Pose3utils.cc:111-119).
    """
    rho, w = v[:3], v[3:]
    Wh = hat(w)
    Z = jnp.zeros((3, 3), v.dtype)
    return jnp.concatenate(
        [
            jnp.concatenate([Wh, hat(rho)], axis=1),
            jnp.concatenate([Z, Wh], axis=1),
        ],
        axis=0,
    )


def circle_dot(p: jax.Array) -> jax.Array:
    """Barfoot's 4x6 "circle-dot" operator [[I, -hat(p)],[0, 0]].

    Mirrors `CircleDot` (Pose3utils.cc:75-80): for homogeneous point
    h = [p, 1], d(exp(xi) h)/d xi |_0 = circle_dot(p).
    """
    top = jnp.concatenate([jnp.eye(3, dtype=p.dtype), -hat(p)], axis=1)
    return jnp.concatenate([top, jnp.zeros((1, 6), p.dtype)], axis=0)


def _Q_coeffs(theta2: jax.Array):
    """Coefficients of Barfoot's Q block, series-safe (theta^4 accurate)."""
    dt = theta2.dtype
    small = theta2 < _small_threshold2(dt)
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe2)
    s, c = jnp.sin(theta), jnp.cos(theta)
    t3 = safe2 * theta
    t4 = safe2 * safe2
    t5 = t4 * theta
    th4 = theta2 * theta2
    # cQ2 = (t - sin t)/t^3                     -> 1/6 - t^2/120 + t^4/5040
    cQ2 = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0 + th4 / 5040.0, (theta - s) / t3)
    # cQ3 = (1 - t^2/2 - cos t)/t^4             -> -1/24 + t^2/720 - t^4/40320
    cQ3 = jnp.where(
        small,
        -1.0 / 24.0 + theta2 / 720.0 - th4 / 40320.0,
        (1.0 - 0.5 * safe2 - c) / t4,
    )
    # cQ4 = cQ3 - 3 (t - sin t - t^3/6)/t^5     -> -1/60 + t^2/1260 - t^4/60480
    cQ4 = jnp.where(
        small,
        -1.0 / 60.0 + theta2 / 1260.0 - th4 / 60480.0,
        cQ3 - 3.0 * (theta - s - t3 / 6.0) / t5,
    )
    return cQ2, cQ3, cQ4


@exact
def left_jacobian_pose3_Q(xi: jax.Array) -> jax.Array:
    """The 3x3 translation-rotation coupling block of the SE(3) left Jacobian.

    Barfoot's closed form (State Estimation, eq. 7.86); mirrors
    `LeftJacobianPose3Q` (Pose3utils.cc:5-22). Note: the reference's small
    angle branch flips the signs of two O(theta^2) terms relative to its own
    closed form; we keep Barfoot's signs (validated against finite
    differences), which agree with the reference in its live regime.
    """
    rho, w = xi[:3], xi[3:]
    X = hat(w)
    Y = hat(rho)
    XY = smm(X, Y)
    YX = smm(Y, X)
    XYX = smm(X, YX)
    theta2 = jnp.dot(w, w)
    cQ2, cQ3, cQ4 = _Q_coeffs(theta2)
    return (
        0.5 * Y
        + cQ2 * (XY + YX + XYX)
        - cQ3 * (smm(X, XY) + smm(YX, X) - 3.0 * XYX)
        - 0.5 * cQ4 * (smm(XYX, X) + smm(X, XYX))
    )


def left_jacobian_pose3(xi: jax.Array) -> jax.Array:
    """SE(3) left Jacobian [[Jl, Q],[0, Jl]] (Pose3utils.cc:24-30)."""
    w = xi[3:]
    Q = left_jacobian_pose3_Q(xi)
    J = left_jacobian_so3(w)
    out = jnp.zeros((6, 6), dtype=xi.dtype)
    out = out.at[:3, :3].set(J)
    out = out.at[:3, 3:].set(Q)
    return out.at[3:, 3:].set(J)


def right_jacobian_pose3(xi: jax.Array) -> jax.Array:
    """Jr(xi) = Jl(-xi) (Pose3utils.cc:32-34)."""
    return left_jacobian_pose3(-xi)


@exact
def left_jacobian_pose3_inv(xi: jax.Array) -> jax.Array:
    """[[Jl^-1, -Jl^-1 Q Jl^-1],[0, Jl^-1]] (Pose3utils.cc:44-46)."""
    w = xi[3:]
    Q = left_jacobian_pose3_Q(xi)
    Jinv = left_jacobian_so3_inv(w)
    out = jnp.zeros((6, 6), dtype=xi.dtype)
    out = out.at[:3, :3].set(Jinv)
    out = out.at[:3, 3:].set(-smm(smm(Jinv, Q), Jinv))
    return out.at[3:, 3:].set(Jinv)


def right_jacobian_pose3_inv(xi: jax.Array) -> jax.Array:
    """Jr^-1(xi) = Jl^-1(-xi) (Pose3utils.cc:40-42)."""
    return left_jacobian_pose3_inv(-xi)


@exact
def transform_point(T: jax.Array, p: jax.Array) -> jax.Array:
    """Apply rigid transform to a 3D point."""
    return smm(T[:3, :3], p) + T[:3, 3]
