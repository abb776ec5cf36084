"""Reprojection factors: pinhole/stereo, at-state and GP-interpolated.

JAX rebuild of the reference's factor library (G2oTypes.cc):
  * EdgeMono / EdgeStereo            — reprojection at the keyframe state
  * EdgeMonoOnlyPose / EdgeStereoOnlyPose — fixed-landmark variants
  * EdgeMonoGP / EdgeStereoGP        — reprojection at an async-camera
    timestamp through the GP-interpolated pose (two pose-vel vertices)
  * EdgeMonoGPExtrinsic              — + free camera extrinsic vertex

Every factor is an unbatched pure function returning the residual and the
analytic Jacobians wrt each connected vertex's retraction
(``T <- T*exp(dxi)``, ``v <- v+dv``, ``Xw <- Xw+dX``, ``Tbc <- Tbc*exp(de)``),
transcribed from the hand-derived chain rules in G2oTypes.cc:120-510 and
unit-tested against `jax.jacfwd` of the residual. The solver `vmap`s them
over edge arrays (SoA), which XLA fuses into large batched contractions.

Conventions: state pose is Twb (body->world), world landmark Xw, camera
extrinsic Tbc (camera->body); residual = obs - project(...) as in the
reference. Camera intrinsics are a 4-vector (fx, fy, cx, cy) (Pinhole.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import gp, lie
from ..ops.precision import exact, smm


def project_pinhole(K: jax.Array, Xc: jax.Array) -> jax.Array:
    """Pinhole projection (Pinhole.cpp:35-41). K = (fx, fy, cx, cy)."""
    invz = 1.0 / Xc[2]
    return jnp.stack([K[0] * Xc[0] * invz + K[2], K[1] * Xc[1] * invz + K[3]])


def project_jac_pinhole(K: jax.Array, Xc: jax.Array) -> jax.Array:
    """2x3 d(project)/dXc (Pinhole.cpp:71-81)."""
    invz = 1.0 / Xc[2]
    invz2 = invz * invz
    z = jnp.zeros_like(invz)
    return jnp.stack(
        [
            jnp.stack([K[0] * invz, z, -K[0] * Xc[0] * invz2]),
            jnp.stack([z, K[1] * invz, -K[1] * Xc[1] * invz2]),
        ]
    )


def project_stereo(K: jax.Array, bf: jax.Array, Xc: jax.Array) -> jax.Array:
    """(u_l, v_l, u_r) with u_r = u_l - bf/z (PoseVelocity::ProjectStereo)."""
    uv = project_pinhole(K, Xc)
    return jnp.concatenate([uv, uv[:1] - bf / Xc[2]])


def project_jac_stereo(K: jax.Array, bf: jax.Array, Xc: jax.Array) -> jax.Array:
    """3x3 stereo projection Jacobian (EdgeStereo::linearizeOplus)."""
    J2 = project_jac_pinhole(K, Xc)
    inv_z2 = 1.0 / (Xc[2] * Xc[2])
    row_r = J2[0].at[2].add(bf * inv_z2)
    return jnp.concatenate([J2, row_r[None, :]], axis=0)


def _se3_deriv(Rcb: jax.Array, Xb: jax.Array) -> jax.Array:
    """3x6 dXc/d(dxi) for Twb <- Twb exp(dxi): [-Rcb, Rcb*hat(Xb)]."""
    return jnp.concatenate([-Rcb, smm(Rcb, lie.hat(Xb))], axis=1)


@exact
def mono_residual(Twb, Tbc, K, Xw, obs):
    """err = obs - pi(Tcb * Twb^-1 * Xw)  (EdgeMono/EdgeMonoOnlyPose)."""
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_pinhole(K, Xc), Xc


@exact
def mono_residual_jac(Twb, Tbc, K, Xw, obs):
    """Residual + Jacobians wrt 12-dof pose-vel state and landmark.

    Returns (r, J_pose (2,12), J_point (2,3), Xc). Velocity block is zero
    (G2oTypes.cc:120-137, 455-475).
    """
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[:3, :3]
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    J_pose6 = -smm(pj, _se3_deriv(Rcb, Xb))
    J_pose = jnp.concatenate([J_pose6, jnp.zeros_like(J_pose6)], axis=1)
    Rbw = Twb[:3, :3].T
    J_point = -smm(smm(pj, Rcb), Rbw)
    return r, J_pose, J_point, Xc


@exact
def stereo_residual(Twb, Tbc, K, bf, Xw, obs):
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_stereo(K, bf, Xc), Xc


@exact
def stereo_residual_jac(Twb, Tbc, K, bf, Xw, obs):
    """(r, J_pose (3,12), J_point (3,3), Xc) (G2oTypes.cc:139-160, 477-510)."""
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[:3, :3]
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    J_pose6 = -smm(pj, _se3_deriv(Rcb, Xb))
    J_pose = jnp.concatenate([J_pose6, jnp.zeros_like(J_pose6)], axis=1)
    Rbw = Twb[:3, :3].T
    J_point = -smm(smm(pj, Rcb), Rbw)
    return r, J_pose, J_point, Xc


# ---------------------------------------------------------------------------
# GP-interpolated reprojection (async cameras)
# ---------------------------------------------------------------------------


def _gp_vertex_chains(dT, xi12, v2, t1, t2, t, dtype):
    """The shared Jacobian chain blocks of all GP-interpolated factors.

    Returns (Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2): the maps
    from perturbations of the endpoint states to the perturbation of the
    interpolated local pose increment (G2oTypes.cc:177-223).
    """
    dxi = lie.log_se3(dT)
    Ad_dT = lie.adj_se3(lie.exp_se3(-dxi))
    Jr_dxi = lie.right_jacobian_pose3(dxi)
    Jr_inv_xi12 = lie.right_jacobian_pose3_inv(xi12)
    ad_v2 = lie.se3_ad(v2)
    Ad_T12_inv = lie.adj_se3(lie.se3_inv(lie.exp_se3(xi12)))

    z6 = jnp.zeros((6, 6), dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    top_T1 = -smm(Jr_inv_xi12, Ad_T12_inv)
    JinT1 = jnp.concatenate([top_T1, -0.5 * smm(ad_v2, top_T1)], axis=0)  # (12,6)
    JinV1 = jnp.concatenate([z6, eye6], axis=0)
    JinT2 = jnp.concatenate([Jr_inv_xi12, -0.5 * smm(ad_v2, Jr_inv_xi12)], axis=0)
    JinV2 = jnp.concatenate([z6, Jr_inv_xi12], axis=0)

    a11, a12, p11, p12 = gp.interp_coeffs(t1, t2, t)
    At1 = jnp.concatenate([a11 * eye6, a12 * eye6], axis=1)
    Pt1 = jnp.concatenate([p11 * eye6, p12 * eye6], axis=1)
    return Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2


@exact
def mono_gp_residual(T1, v1, t1, T2, v2, t2, t, Tbc, K, Xw, obs):
    """err = obs - pi(Tcb * QueryPose(...)^-1 * Xw) (EdgeMonoGP*::computeError)."""
    eye = jnp.eye(6, dtype=T1.dtype)
    Twb, _ = gp.query_pose_aux(T1, T2, v1, v2, t1, t2, t, eye, eye)
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_pinhole(K, Xc), Xc


@exact
def mono_gp_residual_jac(T1, v1, t1, T2, v2, t2, t, Tbc, K, Xw, obs):
    """GP-interpolated mono reprojection: residual + analytic Jacobians.

    Returns (r, J1 (2,12), J2 (2,12), J_point (2,3), J_ext (2,6), Xc):
    Jacobians wrt both endpoint pose-vel states, the landmark, and the
    extrinsic (G2oTypes.cc:177-223 for OnlyPose; :258-314 adds the point and
    extrinsic blocks of EdgeMonoGP/EdgeMonoGPExtrinsic).
    """
    dtype = T1.dtype
    eye = jnp.eye(6, dtype=dtype)
    Twb, (At1, Pt1, dT, xi12) = gp.query_pose_aux(
        T1, T2, v1, v2, t1, t2, t, eye, eye
    )
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[:3, :3]
    Rbw = Twb[:3, :3].T
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_pinhole(K, Xc)

    pj = project_jac_pinhole(K, Xc)
    J1cam = -smm(pj, _se3_deriv(Rcb, Xb))  # (2,6): d r / d (interpolated pose)
    Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2 = _gp_vertex_chains(
        dT, xi12, v2, t1, t2, t, dtype
    )
    JrP = smm(Jr_dxi, Pt1)  # (6,12)
    J1_T = smm(J1cam, smm(JrP, JinT1) + Ad_dT)  # (2,6)
    J1_V = smm(J1cam, smm(smm(Jr_dxi, At1), JinV1))  # (2,6)
    J1 = jnp.concatenate([J1_T, J1_V], axis=1)
    Jj1 = smm(J1cam, JrP)  # (2,12)
    J2 = jnp.concatenate([smm(Jj1, JinT2), smm(Jj1, JinV2)], axis=1)
    J_point = -smm(smm(pj, Rcb), Rbw)
    # Extrinsic block (EdgeMonoGPExtrinsic, G2oTypes.cc:311-314):
    # d r / d (Tbc exp(de)) = -pj @ [-I, hat(Xc)]
    J_ext = -smm(pj, jnp.concatenate([-jnp.eye(3, dtype=dtype), lie.hat(Xc)], axis=1))
    return r, J1, J2, J_point, J_ext, Xc


@exact
def stereo_gp_residual_jac(T1, v1, t1, T2, v2, t2, t, Tbc, K, bf, Xw, obs):
    """GP-interpolated stereo reprojection (EdgeStereoGP, G2oTypes.cc:373-443).

    Returns (r, J1 (3,12), J2 (3,12), J_point (3,3), Xc).
    """
    dtype = T1.dtype
    eye = jnp.eye(6, dtype=dtype)
    Twb, (At1, Pt1, dT, xi12) = gp.query_pose_aux(
        T1, T2, v1, v2, t1, t2, t, eye, eye
    )
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[:3, :3]
    Rbw = Twb[:3, :3].T
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_stereo(K, bf, Xc)

    pj = project_jac_stereo(K, bf, Xc)
    J1cam = -smm(pj, _se3_deriv(Rcb, Xb))
    Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2 = _gp_vertex_chains(
        dT, xi12, v2, t1, t2, t, dtype
    )
    JrP = smm(Jr_dxi, Pt1)
    J1 = jnp.concatenate(
        [smm(J1cam, smm(JrP, JinT1) + Ad_dT),
         smm(J1cam, smm(smm(Jr_dxi, At1), JinV1))], axis=1
    )
    Jj1 = smm(J1cam, JrP)
    J2 = jnp.concatenate([smm(Jj1, JinT2), smm(Jj1, JinV2)], axis=1)
    J_point = -smm(smm(pj, Rcb), Rbw)
    return r, J1, J2, J_point, Xc


# ---------------------------------------------------------------------------
# Packed GP-interpolated evaluation (solver fast path)
# ---------------------------------------------------------------------------
#
# The chain blocks JinT1/JinT2/JinV2 and xi12/nu2 depend only on the POSE
# PAIR, not on the per-observation timestamp: computing them once per unique
# pair (~K structures) instead of per edge (~10k) removes most of the 6x6
# chain work. Additionally At1/Pt1 are scalar-block ([a*I, b*I]), so every
# 6x12/12x6 product collapses to scalar combinations of M = J1cam @ Jr(dxi):
#
#   J1 = [p11*M@A1 + p12*M@B1 + J1cam@Ad(dT^-1),  a12*M]
#   J2 = [p11*M@Jr_inv + p12*M@B2,                p12*M@Jr_inv]
#
# with A1 = -Jr_inv Ad(T12)^-1, B1 = -1/2 ad(v2) A1, B2 = -1/2 ad(v2) Jr_inv.
# Algebraically identical to mono/stereo_gp_residual_jac (tested to 1e-12).


@exact
def gp_pair_pack(T1, v1, T2, v2):
    """Per-pose-pair quantities shared by all GP edges on (T1,v1)->(T2,v2)."""
    xi12 = lie.log_se3(smm(lie.se3_inv(T1), T2))
    Jr_inv = lie.right_jacobian_pose3_inv(xi12)
    nu2 = smm(Jr_inv, v2)
    ad_v2 = lie.se3_ad(v2)
    A1 = -smm(Jr_inv, lie.adj_se3(lie.se3_inv(lie.exp_se3(xi12))))
    B1 = -0.5 * smm(ad_v2, A1)
    B2 = -0.5 * smm(ad_v2, Jr_inv)
    return {"xi12": xi12, "nu2": nu2, "Jr_inv": Jr_inv, "A1": A1,
            "B1": B1, "B2": B2}


def _gp_edge_core(pack, T1, v1, t1, t2, t, Tbc, Xw, dtype):
    """Shared per-edge geometry: interpolated pose + camera point + the
    pair-pack scalar coefficients."""
    a11, a12, p11, p12 = gp.interp_coeffs(t1, t2, t)
    dxi = a12 * v1 + p11 * pack["xi12"] + p12 * pack["nu2"]
    dT = lie.exp_se3(dxi)
    Twb = smm(T1, dT)
    Tcb = lie.se3_inv(Tbc)
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    Ad_dT = lie.adj_se3(lie.se3_inv(dT))
    Jr_dxi = lie.right_jacobian_pose3(dxi)
    return (a12, p11, p12), Twb, Tcb, Xb, Xc, Ad_dT, Jr_dxi


def _gp_jac_from_M(M, J1cam, Ad_dT, pack, coeffs):
    a12, p11, p12 = coeffs
    J1 = jnp.concatenate(
        [p11 * smm(M, pack["A1"]) + p12 * smm(M, pack["B1"]) + smm(J1cam, Ad_dT),
         a12 * M],
        axis=1,
    )
    MJr = smm(M, pack["Jr_inv"])
    J2 = jnp.concatenate([p11 * MJr + p12 * smm(M, pack["B2"]), p12 * MJr], axis=1)
    return J1, J2


@exact
def mono_gp_residual_jac_packed(pack, T1, v1, t1, t2, t, Tbc, K, Xw, obs):
    """Fast-path EdgeMonoGP[Extrinsic] evaluation from a pair pack.

    Returns (r, J1 (2,12), J2 (2,12), J_point (2,3), J_ext (2,6), Xc) —
    identical to mono_gp_residual_jac.
    """
    dtype = T1.dtype
    coeffs, Twb, Tcb, Xb, Xc, Ad_dT, Jr_dxi = _gp_edge_core(
        pack, T1, v1, t1, t2, t, Tbc, Xw, dtype
    )
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    Rcb = Tcb[:3, :3]
    J1cam = -smm(pj, _se3_deriv(Rcb, Xb))
    M = smm(J1cam, Jr_dxi)
    J1, J2 = _gp_jac_from_M(M, J1cam, Ad_dT, pack, coeffs)
    J_point = -smm(smm(pj, Rcb), Twb[:3, :3].T)
    J_ext = -smm(pj, jnp.concatenate([-jnp.eye(3, dtype=dtype), lie.hat(Xc)], axis=1))
    return r, J1, J2, J_point, J_ext, Xc


@exact
def stereo_gp_residual_jac_packed(pack, T1, v1, t1, t2, t, Tbc, K, bf, Xw, obs):
    """Fast-path EdgeStereoGP evaluation from a pair pack."""
    dtype = T1.dtype
    coeffs, Twb, Tcb, Xb, Xc, Ad_dT, Jr_dxi = _gp_edge_core(
        pack, T1, v1, t1, t2, t, Tbc, Xw, dtype
    )
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    Rcb = Tcb[:3, :3]
    J1cam = -smm(pj, _se3_deriv(Rcb, Xb))
    M = smm(J1cam, Jr_dxi)
    J1, J2 = _gp_jac_from_M(M, J1cam, Ad_dT, pack, coeffs)
    J_point = -smm(smm(pj, Rcb), Twb[:3, :3].T)
    return r, J1, J2, J_point, Xc


# ---------------------------------------------------------------------------
# Interp packs: per-(pose-pair, timestamp) hoisting
# ---------------------------------------------------------------------------
# Every GP edge whose observation was triggered at the same camera timestamp
# shares the ENTIRE interpolation chain: the expensive per-edge work of the
# packed path (exp_se3, adj, the Barfoot right Jacobian with its Q block) is
# a function of (pose pair, t) only, never of the landmark.  The pose
# Jacobians factor exactly as  [J1 | J2] = J1cam @ Q  with J1cam the (2,6)
# per-edge camera chain and Q a per-(pair,t) (6,24) matrix, so hundreds of
# features from one camera trigger reuse one chain evaluation.  Async
# cameras fire at fixed per-camera phases (System.cc:213-218, Frame.cc:200),
# so real windows have O(K * C) unique (pair, t) combos vs O(10^4) edges.


@exact
def gp_interp_pack(pack, T1, v1, t1, t2, t):
    """Per-(pose-pair, timestamp) interpolation pack.

    Returns {"Twb", "Tbw", "Q"} where Twb is the GP-interpolated body pose
    at t and Q (6,24) is the right factor of the pose Jacobians:
    J1 = J1cam @ Q[:, :12], J2 = J1cam @ Q[:, 12:24] — algebraically
    identical to mono_gp_residual_jac_packed's chain (G2oTypes.cc:177-223).
    """
    _, a12, p11, p12 = gp.interp_coeffs(t1, t2, t)
    dxi = a12 * v1 + p11 * pack["xi12"] + p12 * pack["nu2"]
    dT = lie.exp_se3(dxi)
    Twb = smm(T1, dT)
    Ad_dT = lie.adj_se3(lie.se3_inv(dT))
    Jr_dxi = lie.right_jacobian_pose3(dxi)
    Q1 = smm(Jr_dxi, p11 * pack["A1"] + p12 * pack["B1"]) + Ad_dT
    Q2 = a12 * Jr_dxi
    Q3 = smm(Jr_dxi, p11 * pack["Jr_inv"] + p12 * pack["B2"])
    Q4 = p12 * smm(Jr_dxi, pack["Jr_inv"])
    Q = jnp.concatenate([Q1, Q2, Q3, Q4], axis=1)
    return {"Twb": Twb, "Tbw": lie.se3_inv(Twb), "Q": Q}


@exact
def mono_gp_residual_jac_interp(ip, Tbc, K, Xw, obs):
    """EdgeMonoGP[Extrinsic] from an interp pack: per-edge work is one point
    transform + projection + a (2,6)@(6,24) contraction."""
    dtype = Xw.dtype
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[:3, :3]
    Xb = lie.transform_point(ip["Tbw"], Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    J1cam = -smm(pj, _se3_deriv(Rcb, Xb))
    J12 = smm(J1cam, ip["Q"])  # (2,24)
    J1, J2 = J12[:, :12], J12[:, 12:]
    J_point = -smm(smm(pj, Rcb), ip["Twb"][:3, :3].T)
    J_ext = -smm(
        pj, jnp.concatenate([-jnp.eye(3, dtype=dtype), lie.hat(Xc)], axis=1)
    )
    return r, J1, J2, J_point, J_ext, Xc


@exact
def stereo_gp_residual_jac_interp(ip, Tbc, K, bf, Xw, obs):
    """EdgeStereoGP from an interp pack."""
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[:3, :3]
    Xb = lie.transform_point(ip["Tbw"], Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    J1cam = -smm(pj, _se3_deriv(Rcb, Xb))
    J12 = smm(J1cam, ip["Q"])  # (3,24)
    J1, J2 = J12[:, :12], J12[:, 12:]
    J_point = -smm(smm(pj, Rcb), ip["Twb"][:3, :3].T)
    return r, J1, J2, J_point, Xc


@exact
def mono_gp_residual_interp(Tbw, Tbc, K, Xw, obs):
    """Residual-only mono-GP from a gathered interpolated pose inverse."""
    Xb = lie.transform_point(Tbw, Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_pinhole(K, Xc)


@exact
def stereo_gp_residual_interp(Tbw, Tbc, K, bf, Xw, obs):
    Xb = lie.transform_point(Tbw, Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_stereo(K, bf, Xc)
