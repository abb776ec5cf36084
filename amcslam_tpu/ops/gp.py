"""Sparse Gaussian-process motion prior on SE(3) x R^6 (WNOA / const-velocity).

JAX rebuild of the reference's `src/GaussianProcess.cc` +
`include/GaussianProcess.h`: the process-noise kernel ``Qi(dt)`` and its
closed-form inverse, the constant-velocity transition ``Phi``, and GP pose
interpolation ``query_pose`` between two (pose, world-twist) states — the
core mechanism that lets asynchronous cameras constrain existing keyframe
states instead of adding per-timestamp poses.

State convention: 12-dim local state ``x = [xi (6), nu (6)]`` with the se(3)
tangent ordered [rho, omega] (translation first, matching Sophus and the
reference). ``Qc`` is the 6x6 power-spectral-density of the white-noise-on-
acceleration prior; the reference configures it diagonal (Tracking.cc:735-782)
but we accept any SPD 6x6.

All functions are pure, dtype-follow-input, and vmap-friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import lie
from .precision import exact, smm


def qi(dt: jax.Array, Qc: jax.Array) -> jax.Array:
    """Process-noise covariance over an interval dt (GaussianProcess.h:22-32).

    Qi = [[dt^3/3 Qc, dt^2/2 Qc], [dt^2/2 Qc, dt Qc]]  (12x12).
    """
    dt2 = dt * dt
    dt3 = dt2 * dt
    top = jnp.concatenate([dt3 / 3.0 * Qc, dt2 / 2.0 * Qc], axis=1)
    bot = jnp.concatenate([dt2 / 2.0 * Qc, dt * Qc], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def qi_inv(dt: jax.Array, Qc_inv: jax.Array) -> jax.Array:
    """Closed-form inverse of :func:`qi` (GaussianProcess.h:34-45).

    QiInv = [[12/dt^3 QcInv, -6/dt^2 QcInv], [-6/dt^2 QcInv, 4/dt QcInv]].
    """
    dt2 = dt * dt
    dt3 = dt2 * dt
    top = jnp.concatenate([12.0 / dt3 * Qc_inv, -6.0 / dt2 * Qc_inv], axis=1)
    bot = jnp.concatenate([-6.0 / dt2 * Qc_inv, 4.0 / dt * Qc_inv], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def transition(dt: jax.Array, dtype=None) -> jax.Array:
    """Constant-velocity transition Phi(t1,t2) = [[I, dt I],[0, I]] (12x12)."""
    dtype = dtype or jnp.result_type(dt)
    eye6 = jnp.eye(6, dtype=dtype)
    z6 = jnp.zeros((6, 6), dtype=dtype)
    top = jnp.concatenate([eye6, dt * eye6], axis=1)
    bot = jnp.concatenate([z6, eye6], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def interp_coeffs(t1, t2, t):
    """Scalar interpolation coefficients (a11, a12, p11, p12) such that the
    pose rows of the WNOA interpolation matrices are

        At1 = [a11*I6, a12*I6],   Pt1 = [p11*I6, p12*I6].

    The reference computes At1/Pt1 as Qi(t-t1) Phi(t,t2)^T QiInv(t2-t1)
    products (GaussianProcess.cc:5-13); because every block of Qi is a scalar
    multiple of Qc and every block of QiInv a scalar multiple of Qc^-1, the
    product collapses to cubic-Hermite basis polynomials in s = (t-t1)/dt,
    independent of Qc:

        a11 = 1 - 3s^2 + 2s^3      a12 = dt * s (1-s)^2
        p11 = s^2 (3 - 2s)         p12 = dt * s^2 (s - 1)

    This closed form is exact (verified against the matrix products in f64)
    and, unlike the product chain that mixes O(dt^3) with O(1/dt^3) scales,
    is well conditioned in float32, the production dtype on device.
    """
    dt = t2 - t1
    s = (t - t1) / dt
    s2 = s * s
    a11 = 1.0 - 3.0 * s2 + 2.0 * s2 * s
    a12 = dt * s * (1.0 - s) * (1.0 - s)
    p11 = s2 * (3.0 - 2.0 * s)
    p12 = dt * s2 * (s - 1.0)
    return a11, a12, p11, p12


def interp_matrices(t1, t2, t, Qc: jax.Array, Qc_inv: jax.Array):
    """Interpolation matrices (At1, Pt1): the top 6x12 rows of

    Pt = Qi(t - t1) Phi(t, t2)^T QiInv(t2 - t1)
    At = Phi(t1, t) - Pt Phi(t1, t2)

    (GaussianProcess.cc:5-13), materialized from the closed Hermite form of
    :func:`interp_coeffs`. Qc/Qc_inv only fix the dtype.
    """
    dtype = Qc.dtype
    a11, a12, p11, p12 = interp_coeffs(t1, t2, t)
    eye6 = jnp.eye(6, dtype=dtype)
    At1 = jnp.concatenate([a11 * eye6, a12 * eye6], axis=1)
    Pt1 = jnp.concatenate([p11 * eye6, p12 * eye6], axis=1)
    return At1, Pt1


@exact
def local_state(T1: jax.Array, T2: jax.Array, v2: jax.Array):
    """(xi12, x2) with x2 = [log(T1^-1 T2); Jr^-1(xi12) v2] (GaussianProcess.cc:14-19)."""
    xi12 = lie.log_se3(smm(lie.se3_inv(T1), T2))
    x2 = jnp.concatenate([xi12, smm(lie.right_jacobian_pose3_inv(xi12), v2)])
    return xi12, x2


def query_pose(T1, T2, v1, v2, t1, t2, t, Qc, Qc_inv):
    """GP-interpolated body pose at time t in (t1, t2).

    T(t) = T1 * exp(At1 @ [0; v1] + Pt1 @ [xi12; Jr^-1(xi12) v2])
    (GaussianProcess.cc:5-22). Returns the 4x4 interpolated pose.
    """
    T, _aux = query_pose_aux(T1, T2, v1, v2, t1, t2, t, Qc, Qc_inv)
    return T


@exact
def query_pose_aux(T1, T2, v1, v2, t1, t2, t, Qc, Qc_inv):
    """As :func:`query_pose` but also returns (At1, Pt1, dT, xi12) — the
    quantities needed by the analytic Jacobians of GP-interpolated
    reprojection factors (second QueryPose overload, GaussianProcess.cc:24-44).
    """
    a11, a12, p11, p12 = interp_coeffs(t1, t2, t)
    xi12 = lie.log_se3(smm(lie.se3_inv(T1), T2))
    nu2 = smm(lie.right_jacobian_pose3_inv(xi12), v2)
    # dxi = At1 @ [0; v1] + Pt1 @ [xi12; nu2], expanded in the scalar form.
    dxi = a12 * v1 + p11 * xi12 + p12 * nu2
    dT = lie.exp_se3(dxi)
    At1, Pt1 = interp_matrices(t1, t2, t, Qc, Qc_inv)
    return smm(T1, dT), (At1, Pt1, dT, xi12)
