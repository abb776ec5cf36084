"""Monocular two-view initializer (rebuild of src/TwoViewReconstruction.cc).

Parallel 8-point fundamental + 4-point homography RANSAC with robust
symmetric-transfer scoring, model selection RH = SH/(SH+SF), and motion
recovery: E-decomposition (4 hypotheses) or Faugeras homography
decomposition (8 hypotheses), each cheirality-checked by triangulating all
matches. Dormant in the reference pipeline (monocular init commented out,
Tracking.cc:1506-1569) but named in BASELINE.json; reachable via
`GeometricCamera::ReconstructWithTwoViews` parity.

Device design: the reference's serial RANSAC becomes one vmapped program — all
hypotheses, all models, and all 12 candidate motions score simultaneously;
triangulation is a batched 4x4 SVD.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..frontend.cameras import triangulate_dlt
from ..ops import lie

TH_F = 3.841
TH_SCORE = 5.991
TH_H = 5.991


class TwoViewData(NamedTuple):
    kp1: jax.Array    # (N,2) pixel coords in image 1
    kp2: jax.Array    # (N,2)
    valid: jax.Array  # (N,) bool
    K: jax.Array      # (4,) fx, fy, cx, cy
    sigma: jax.Array  # () pixel noise scale


def _K_matrix(K4, dtype):
    return jnp.asarray(
        [[K4[0], 0.0, K4[2]], [0.0, K4[1], K4[3]], [0.0, 0.0, 1.0]], dtype=dtype
    )


def _normalize(kp, valid):
    """Hartley normalization with mean absolute deviation (Normalize())."""
    n = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(jnp.where(valid[:, None], kp, 0.0), 0) / n
    dev = jnp.sum(jnp.where(valid[:, None], jnp.abs(kp - mean), 0.0), 0) / n
    s = 1.0 / jnp.maximum(dev, 1e-9)
    kpn = (kp - mean) * s
    T = jnp.asarray(
        [
            [s[0], 0.0, -mean[0] * s[0]],
            [0.0, s[1], -mean[1] * s[1]],
            [0.0, 0.0, 1.0],
        ],
        dtype=kp.dtype,
    )
    return kpn, T


def _fundamental_8pt(p1, p2):
    """F from 8 normalized correspondences (ComputeF21): SVD + rank-2."""
    u1, v1 = p1[:, 0], p1[:, 1]
    u2, v2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=1
    )
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[-1].reshape(3, 3)
    U, w, Vt2 = jnp.linalg.svd(F)
    w = w.at[2].set(0.0)
    return U @ jnp.diag(w) @ Vt2


def _homography_4pt(p1, p2):
    """H from 4 normalized correspondences (ComputeH21 DLT)."""
    u1, v1 = p1[:4, 0], p1[:4, 1]
    u2, v2 = p2[:4, 0], p2[:4, 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], 1)
    r2 = jnp.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], 1)
    A = jnp.concatenate([r1, r2], 0)  # (8,9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[-1].reshape(3, 3)


def _score_F(F, data: TwoViewData):
    """CheckFundamental (TwoViewReconstruction.cc:395-473): symmetric epipolar
    transfer with th=3.841, score term thScore=5.991."""
    inv_s2 = 1.0 / (data.sigma * data.sigma)
    x1 = jnp.concatenate([data.kp1, jnp.ones((data.kp1.shape[0], 1), F.dtype)], 1)
    x2 = jnp.concatenate([data.kp2, jnp.ones((data.kp2.shape[0], 1), F.dtype)], 1)
    l2 = x1 @ F.T  # lines in image 2
    num2 = jnp.sum(l2 * x2, 1)
    d1 = num2 * num2 / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-18)
    l1 = x2 @ F
    num1 = jnp.sum(l1 * x1, 1)
    d2 = num1 * num1 / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-18)
    c1 = d1 * inv_s2
    c2 = d2 * inv_s2
    good = (c1 <= TH_F) & (c2 <= TH_F) & data.valid
    score = jnp.sum(
        jnp.where(data.valid & (c1 <= TH_F), TH_SCORE - c1, 0.0)
        + jnp.where(data.valid & (c2 <= TH_F), TH_SCORE - c2, 0.0)
    )
    return score, good


def _score_H(H, data: TwoViewData):
    """CheckHomography: symmetric reprojection error, th=5.991."""
    inv_s2 = 1.0 / (data.sigma * data.sigma)
    Hinv = jnp.linalg.inv(H)
    x1 = jnp.concatenate([data.kp1, jnp.ones((data.kp1.shape[0], 1), H.dtype)], 1)
    x2 = jnp.concatenate([data.kp2, jnp.ones((data.kp2.shape[0], 1), H.dtype)], 1)
    p12 = x1 @ H.T
    p12 = p12[:, :2] / jnp.where(jnp.abs(p12[:, 2:]) > 1e-12, p12[:, 2:], 1e-12)
    d1 = jnp.sum((data.kp2 - p12) ** 2, 1) * inv_s2
    p21 = x2 @ Hinv.T
    p21 = p21[:, :2] / jnp.where(jnp.abs(p21[:, 2:]) > 1e-12, p21[:, 2:], 1e-12)
    d2 = jnp.sum((data.kp1 - p21) ** 2, 1) * inv_s2
    good = (d1 <= TH_H) & (d2 <= TH_H) & data.valid
    score = jnp.sum(
        jnp.where(data.valid & (d1 <= TH_H), TH_H - d1, 0.0)
        + jnp.where(data.valid & (d2 <= TH_H), TH_H - d2, 0.0)
    )
    return score, good


def _decompose_E(E):
    """4 motion hypotheses (R1,t),(R2,t),(R1,-t),(R2,-t) (DecomposeE)."""
    U, _, Vt = jnp.linalg.svd(E)
    t = U[:, 2]
    t = t / jnp.linalg.norm(t)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vt
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    return (R1, R2, t)


def _check_rt(R, t, data: TwoViewData, inliers, th2_reproj):
    """CheckRT: triangulate every inlier match under (R,t), count matches
    with positive depth in both views, bounded reprojection error, and finite
    parallax; returns (nGood, X (N,3), good mask, parallax-50th-ish)."""
    dtype = R.dtype
    Km = _K_matrix(data.K, dtype)
    Kinv = jnp.linalg.inv(Km)
    Tcw1 = jnp.eye(4, dtype=dtype)
    Tcw2 = lie.se3_matrix(R, t)

    def one(kp1, kp2):
        r1 = Kinv @ jnp.concatenate([kp1, jnp.ones(1, dtype)])
        r2 = Kinv @ jnp.concatenate([kp2, jnp.ones(1, dtype)])
        X, w = triangulate_dlt(r1 / r1[2], r2 / r2[2], Tcw1, Tcw2)
        z1 = X[2]
        Xc2 = R @ X + t
        z2 = Xc2[2]
        # parallax between rays
        n1 = X / jnp.maximum(jnp.linalg.norm(X), 1e-12)
        O2 = -R.T @ t
        d2v = X - O2
        n2 = d2v / jnp.maximum(jnp.linalg.norm(d2v), 1e-12)
        cos_par = jnp.dot(n1, n2)
        # reprojection errors
        p1 = Km @ X
        e1 = jnp.sum((p1[:2] / p1[2] - kp1) ** 2)
        p2 = Km @ Xc2
        e2 = jnp.sum((p2[:2] / p2[2] - kp2) ** 2)
        finite = jnp.isfinite(X).all()
        ok = (
            finite
            & (z1 > 0)
            & (z2 > 0)
            & (cos_par < 0.99998)
            & (e1 < th2_reproj)
            & (e2 < th2_reproj)
        )
        return X, ok, cos_par

    X, ok, cos_par = jax.vmap(one)(data.kp1, data.kp2)
    ok = ok & inliers
    n_good = jnp.sum(ok)
    # parallax proxy: max cos among good points after taking the 50th-smallest
    # in the reference; use the median cos of good points
    cp = jnp.where(ok, cos_par, 1.0)
    cp_sorted = jnp.sort(cp)
    idx = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(cp_sorted[idx], -1.0, 1.0)))
    return n_good, X, ok, parallax_deg


def _faugeras_motions(H, K4, dtype):
    """8 (R, t, n) candidates from a homography (ReconstructH)."""
    Km = _K_matrix(K4, dtype)
    Kinv = jnp.linalg.inv(Km)
    A = Kinv @ H @ Km
    U, w, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    degenerate = (d1 / d2 < 1.00001) | (d2 / d3 < 1.00001)

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1v = jnp.asarray([aux1, aux1, -aux1, -aux1], dtype)
    x3v = jnp.asarray([aux3, -aux3, aux3, -aux3], dtype)

    aux_st = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 + d3) * d2)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    sthetav = jnp.asarray([aux_st, -aux_st, -aux_st, aux_st], dtype)

    aux_sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 - d3) * d2)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sphiv = jnp.asarray([aux_sp, -aux_sp, -aux_sp, aux_sp], dtype)

    def case_pos(i):
        Rp = jnp.zeros((3, 3), dtype)
        Rp = Rp.at[0, 0].set(ctheta).at[0, 2].set(-sthetav[i])
        Rp = Rp.at[1, 1].set(1.0)
        Rp = Rp.at[2, 0].set(sthetav[i]).at[2, 2].set(ctheta)
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1v[i], jnp.zeros((), dtype), -x3v[i]]) * (d1 - d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def case_neg(i):
        Rp = jnp.zeros((3, 3), dtype)
        Rp = Rp.at[0, 0].set(cphi).at[0, 2].set(sphiv[i])
        Rp = Rp.at[1, 1].set(-1.0)
        Rp = Rp.at[2, 0].set(sphiv[i]).at[2, 2].set(-cphi)
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1v[i], jnp.zeros((), dtype), x3v[i]]) * (d1 + d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = case_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = case_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts), degenerate


class TwoViewResult(NamedTuple):
    ok: jax.Array            # () bool
    used_homography: jax.Array
    R: jax.Array             # (3,3) T21 rotation
    t: jax.Array             # (3,)
    X: jax.Array             # (N,3) triangulated points
    triangulated: jax.Array  # (N,) bool
    n_good: jax.Array


def reconstruct(
    data: TwoViewData,
    samples: jax.Array,       # (H,8) int32 RANSAC samples
    min_parallax: float = 1.0,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Full two-view reconstruction (Reconstruct, TwoViewReconstruction.cc:41-130).

    All RANSAC hypotheses for both models, then the selected model's motion
    candidates (4 for E, 8 for H), evaluate in parallel.
    """
    dtype = data.kp1.dtype
    kpn1, T1 = _normalize(data.kp1, data.valid)
    kpn2, T2 = _normalize(data.kp2, data.valid)
    ndata = data  # scoring uses raw pixels

    def hypo(idx):
        p1 = kpn1[idx]
        p2 = kpn2[idx]
        Fn = _fundamental_8pt(p1, p2)
        F = T2.T @ Fn @ T1
        sF, _ = _score_F(F, ndata)
        Hn = _homography_4pt(p1, p2)
        H = jnp.linalg.inv(T2) @ Hn @ T1
        H = H / jnp.where(jnp.abs(H[2, 2]) > 1e-12, H[2, 2], 1e-12)
        sH, _ = _score_H(H, ndata)
        return F, sF, H, sH

    F_h, sF_h, H_h, sH_h = jax.vmap(hypo)(samples)
    bi_F = jnp.argmax(sF_h)
    bi_H = jnp.argmax(sH_h)
    F = F_h[bi_F]
    H = H_h[bi_H]
    SF = sF_h[bi_F]
    SH = sH_h[bi_H]
    _, inl_F = _score_F(F, ndata)
    _, inl_H = _score_H(H, ndata)
    RH = SH / jnp.maximum(SH + SF, 1e-12)
    use_H = RH > 0.50

    sigma2 = data.sigma * data.sigma
    Km = _K_matrix(data.K, dtype)

    # --- F path: 4 E-decomposition motions
    E = Km.T @ F @ Km
    R1, R2, tE = _decompose_E(E)
    RsF = jnp.stack([R1, R2, R1, R2])
    tsF = jnp.stack([tE, tE, -tE, -tE])

    # --- H path: 8 Faugeras motions
    RsH, tsH, h_degenerate = _faugeras_motions(H, data.K, dtype)

    Rs = jnp.concatenate([RsF, RsH], 0)   # (12,3,3)
    ts = jnp.concatenate([tsF, tsH], 0)
    inliers = jnp.where(use_H, inl_H, inl_F)

    n_good, Xs, good, par = jax.vmap(
        lambda R, t: _check_rt(R, t, ndata, inliers, 4.0 * sigma2)
    )(Rs, ts)

    cand_mask = jnp.where(
        use_H,
        jnp.arange(12) >= 4,
        jnp.arange(12) < 4,
    )
    n_masked = jnp.where(cand_mask, n_good, -1)
    best = jnp.argmax(n_masked)
    max_good = n_masked[best]
    N_inl = jnp.sum(inliers)
    n_min_good = jnp.maximum((0.9 * N_inl).astype(jnp.int32), min_triangulated)
    # nsimilar: candidates within 70% of the best (ReconstructF:509-517 /
    # ReconstructH analog)
    n_similar = jnp.sum(jnp.where(cand_mask, n_good > 0.7 * max_good, False))
    ok = (
        (max_good >= n_min_good)
        & (n_similar == 1)
        & (par[best] > min_parallax)
        & ~(use_H & h_degenerate)
    )
    return TwoViewResult(
        ok=ok,
        used_homography=use_H,
        R=Rs[best],
        t=ts[best],
        X=Xs[best],
        triangulated=good[best],
        n_good=max_good,
    )
