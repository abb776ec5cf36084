"""Windowed local GP bundle adjustment with landmark Schur complement.

JAX rebuild of `Optimizer::LocalGPBA` (Optimizer.cc:713-1432) and the
g2o BlockSolver Schur machinery (Thirdparty/g2o/g2o/core/block_solver.h:131-172):

  graph = { temporal window of pose-vel KFs (prev KF + covisible KFs fixed),
            per-async-camera extrinsic vertices (fixed unless refined),
            landmarks (marginalized) }
  edges = { velocity regularizers, GP motion priors along the chain,
            extrinsic rotation priors,
            async-camera GP-interpolated mono reprojections (KF + non-KF GPObs),
            GP-interpolated stereo reprojections (non-KF stereo obs),
            stereo-camera mono/stereo reprojections at KF timestamps }

Device mapping: all residuals/Jacobians evaluate as one vmapped batch per edge
type; the block Hessian is assembled with segment-sums (pose-pair blocks are
deduplicated by structure id before scattering — there are only O(K*C)
distinct column sets) plus one scatter-add for the landmark coupling W; the
Schur complement Hpp - W Hll^-1 W^T is two large dense contractions; the
reduced system solves with dense Cholesky. The trust-region loop is
the shared g2o-exact LM driver (solver/lm.py).

Dynamic outlier sets are masks; dynamic graph topology is padding — shapes
stay static across LM iterations and across typical windows (bucket sizes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..factors import gp_prior, priors, reprojection
from ..ops import gp, lie
from . import robust
from .lm import LMCarry, LMProblem, LMStats, lm_init, lm_optimize, lm_segment

# Env-gated PCG convergence tracing (iteration count + relative residual).
import os as _os

_PCG_DEBUG = _os.environ.get("AMCSLAM_PCG_DEBUG", "") == "1"

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
TH_HUBER_MONO = float(np.sqrt(5.991))
TH_HUBER_STEREO = float(np.sqrt(7.815))
TH_HUBER_GP = 21.026  # BundleAdjustment GP-prior delta (Optimizer.cc:130)


class LocalBAData(NamedTuple):
    # --- pose vertices (K = window + fixed anchors)
    times: jax.Array          # (K,)
    pose_fixed: jax.Array     # (K,) bool
    vel_valid: jax.Array      # (K,) bool — velocity edge per optimizable KF
    qcinv22: jax.Array        # scalar
    # --- GP prior chain
    gp_pairs: jax.Array       # (Ng,2) int32 (i -> j consecutive)
    gp_qi_inv: jax.Array      # (Ng,12,12)
    gp_valid: jax.Array       # (Ng,) bool
    gp_huber: jax.Array       # () bool — GBA uses delta=21.026, LocalGPBA none
    # --- camera rig
    Tbc_stereo: jax.Array     # (4,4) stereo-camera extrinsic (not a vertex)
    K_stereo: jax.Array       # (4,)
    bf: jax.Array             # ()
    K_async: jax.Array        # (Cx,4) async camera intrinsics
    ext_fixed: jax.Array      # (Cx,) bool — extrinsic vertices fixed
    R_prior: jax.Array        # (Cx,3,3) extrinsic rotation priors
    ext_info: jax.Array       # (Cx,3,3) prior information
    # --- async-camera GP mono edges (EdgeMonoGPExtrinsic; KF + GPObs)
    mg_pair: jax.Array        # (Em,2) int32 pose pair (i=earlier, j=later)
    mg_lm: jax.Array          # (Em,) int32
    mg_cam: jax.Array         # (Em,) int32 async camera (= extrinsic vertex)
    mg_t: jax.Array           # (Em,)
    mg_obs: jax.Array         # (Em,2)
    mg_w: jax.Array           # (Em,)
    mg_valid: jax.Array       # (Em,) bool
    mg_close: jax.Array       # (Em,) bool
    mg_sid: jax.Array         # (Em,) int32 structure id (unique (pair,cam)
                              # column set; padded edges -> dump segment)
    mg_sid_cols: jax.Array    # (Sm,30) int32 column indices per structure
    # --- GP stereo edges (EdgeStereoGP; non-KF stereo obs)
    sg_pair: jax.Array        # (Eg,2) int32
    sg_lm: jax.Array          # (Eg,) int32
    sg_t: jax.Array           # (Eg,)
    sg_obs: jax.Array         # (Eg,3)
    sg_w: jax.Array           # (Eg,)
    sg_valid: jax.Array       # (Eg,) bool
    sg_sid: jax.Array         # (Eg,) int32
    sg_sid_cols: jax.Array    # (Sg,24) int32
    # --- stereo-camera edges at KF time (EdgeMono/EdgeStereo)
    st_pose: jax.Array        # (Es,) int32
    st_lm: jax.Array          # (Es,) int32
    st_obs: jax.Array         # (Es,3)
    st_w: jax.Array           # (Es,)
    st_valid: jax.Array       # (Es,) bool
    st_is_stereo: jax.Array   # (Es,) bool
    st_close: jax.Array       # (Es,) bool
    # --- optional landmark-major gather tables (make_landmark_tables):
    # scatter-free Wt/Hll/bl assembly. When None, linearize falls back to
    # segment-sums (used by direct LocalBAData constructions).
    lm_blk: jax.Array | None = None        # (L,D) int32 into the flat block
                                           # array [mono-i|mono-j|mono-ext|
                                           # sg-i|sg-j|st]
    lm_blk_g: jax.Array | None = None      # (L,D) int32 column group: pose k
                                           # or K + cam for extrinsics
    lm_blk_valid: jax.Array | None = None  # (L,D) bool
    lm_edge: jax.Array | None = None       # (L,De) int32 into [mono|sg|st]
    lm_edge_valid: jax.Array | None = None  # (L,De) bool
    # --- optional interp-combo tables (build_interp_tables): per-edge index
    # into the unique (structure, timestamp) set, hoisting the whole GP
    # interpolation chain out of the per-edge evaluation (async cameras fire
    # at fixed phases, so U << E in real windows). None -> per-edge chains.
    mg_it: jax.Array | None = None       # (Em,) int32 combo index
    mg_it_sid: jax.Array | None = None   # (Um,) int32 structure per combo
    mg_it_t: jax.Array | None = None     # (Um,) timestamp per combo
    sg_it: jax.Array | None = None       # (Eg,) int32
    sg_it_sid: jax.Array | None = None   # (Ug,) int32
    sg_it_t: jax.Array | None = None     # (Ug,)

    @property
    def n_poses(self):
        return self.times.shape[0]

    @property
    def n_ext(self):
        return self.K_async.shape[0]


class BAState(NamedTuple):
    T: jax.Array     # (K,4,4)
    v: jax.Array     # (K,6)
    Text: jax.Array  # (Cx,4,4)
    X: jax.Array     # (L,3)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate) — no LU on tiny blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def _onehot_gather(idx, n: int, table):
    """Row-gather from a small table as a one-hot contraction.

    For per-edge gathers from small tables (poses, interp packs, extrinsics:
    n <= a few hundred rows) the gather is an (E, n) one-hot matmul. It is
    exact only under the package-global HIGHEST matmul precision: the 0/1
    one-hot then selects each table row bit-for-bit, where TF32 would round
    the table to ~10 mantissa bits. Callers keep plain indexing for large
    tables (landmarks).
    """
    oh = (idx[:, None] == jnp.arange(n)).astype(table.dtype)
    flat = table.reshape(n, -1)
    return (oh @ flat).reshape(idx.shape[0], *table.shape[1:])


def _pair_packs(data: LocalBAData, state: BAState, sid_cols):
    """Per-structure GP pair packs: unique (pose_i, pose_j) chains computed
    once (~K structures) and gathered per edge — see
    factors/reprojection.py gp_pair_pack."""
    i_s = sid_cols[:, 0] // 12
    j_s = sid_cols[:, 12] // 12
    return jax.vmap(
        lambda i, j: reprojection.gp_pair_pack(
            state.T[i], state.v[i], state.T[j], state.v[j]
        )
    )(i_s, j_s)


def _interp_packs(data: LocalBAData, state: BAState, sid_cols, it_sid, it_t):
    """Per-(structure, timestamp) interp packs: pair packs computed per
    structure (~K of them), interpolation chains per unique combo (~K*C),
    gathered per edge by the caller."""
    i_u = sid_cols[it_sid, 0] // 12
    j_u = sid_cols[it_sid, 12] // 12
    # dump combo (structure 0) has i == j -> dt = 0; keep its pack finite
    # (outputs of the edges that gather it are where-masked anyway)
    j_u = jnp.where(j_u == i_u, jnp.minimum(i_u + 1, data.n_poses - 1), j_u)
    # named so a profiler trace can attribute the chain's kernels
    with jax.named_scope("gp_interp_packs"):
        packs = jax.vmap(
            lambda i, j: reprojection.gp_pair_pack(
                state.T[i], state.v[i], state.T[j], state.v[j]
            )
        )(sid_cols[:, 0] // 12, sid_cols[:, 12] // 12)
        pack_u = jax.tree.map(lambda a: a[it_sid], packs)
        return jax.vmap(reprojection.gp_interp_pack)(
            pack_u, state.T[i_u], state.v[i_u],
            data.times[i_u], data.times[j_u], it_t,
        )


def _mono_cam_tables(data: LocalBAData, state: BAState):
    """Per-camera (Tbc, K) tables for mono-GP edges: the Cx async extrinsic
    vertices plus a virtual last row for the stereo camera. A GPObs on the
    stereo camera with no right match is a plain EdgeMonoGP in the reference
    (Optimizer.cc:281-303), which reads the static mTbc[cam] for *any*
    camera while extrinsic vertices exist only for the async ones
    (Optimizer.cc:983-996) — so mg_cam may equal n_ext, selecting this
    non-optimizable stereo row (its extrinsic Jacobian is masked to zero
    via the zero-padded ext_act gather)."""
    Text_all = jnp.concatenate([state.Text, data.Tbc_stereo[None]], axis=0)
    K_all = jnp.concatenate([data.K_async, data.K_stereo[None]], axis=0)
    return Text_all, K_all


def _mono_gp_eval(data: LocalBAData, state: BAState):
    E = data.mg_obs.shape[0]
    if E == 0:
        # static-shape early-out: the interp-pack chain alone costs ~1.2 ms
        # on-chip (hundreds of tiny-kernel launches) even with zero edges
        z = lambda *s: jnp.zeros(s, data.mg_obs.dtype)  # noqa: E731
        return z(0, 2), z(0, 2, 12), z(0, 2, 12), z(0, 2, 3), z(0, 2, 6), z(0, 3)
    if data.mg_it is not None:
        ips = _interp_packs(
            data, state, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t
        )
        IT = data.mg_it_t.shape[0]
        ip_e = jax.tree.map(lambda a: _onehot_gather(data.mg_it, IT, a), ips)
        Text_all, K_all = _mono_cam_tables(data, state)
        Text_e = _onehot_gather(data.mg_cam, data.n_ext + 1, Text_all)
        K_e = _onehot_gather(data.mg_cam, data.n_ext + 1, K_all)

        def one(ip, Tbc, Kc, lm, obs):
            return reprojection.mono_gp_residual_jac_interp(
                ip, Tbc, Kc, state.X[lm], obs
            )

        return jax.vmap(one)(ip_e, Text_e, K_e, data.mg_lm, data.mg_obs)

    packs = _pair_packs(data, state, data.mg_sid_cols)
    pack_e = jax.tree.map(lambda a: a[data.mg_sid], packs)
    Text_all, K_all = _mono_cam_tables(data, state)

    def one(pair, lm, cam, t, obs, pack):
        i, j = pair[0], pair[1]
        return reprojection.mono_gp_residual_jac_packed(
            pack, state.T[i], state.v[i], data.times[i], data.times[j],
            t, Text_all[cam], K_all[cam], state.X[lm], obs,
        )

    return jax.vmap(one)(
        data.mg_pair, data.mg_lm, data.mg_cam, data.mg_t, data.mg_obs, pack_e
    )


def _stereo_gp_eval(data: LocalBAData, state: BAState):
    E = data.sg_obs.shape[0]
    if E == 0:
        z = lambda *s: jnp.zeros(s, data.sg_obs.dtype)  # noqa: E731
        return z(0, 3), z(0, 3, 12), z(0, 3, 12), z(0, 3, 3), z(0, 3)
    if data.sg_it is not None:
        ips = _interp_packs(
            data, state, data.sg_sid_cols, data.sg_it_sid, data.sg_it_t
        )
        IT = data.sg_it_t.shape[0]
        ip_e = jax.tree.map(lambda a: _onehot_gather(data.sg_it, IT, a), ips)

        def one(ip, lm, obs):
            return reprojection.stereo_gp_residual_jac_interp(
                ip, data.Tbc_stereo, data.K_stereo, data.bf, state.X[lm], obs
            )

        return jax.vmap(one)(ip_e, data.sg_lm, data.sg_obs)

    packs = _pair_packs(data, state, data.sg_sid_cols)
    pack_e = jax.tree.map(lambda a: a[data.sg_sid], packs)

    def one(pair, lm, t, obs, pack):
        i, j = pair[0], pair[1]
        return reprojection.stereo_gp_residual_jac_packed(
            pack, state.T[i], state.v[i], data.times[i], data.times[j],
            t, data.Tbc_stereo, data.K_stereo, data.bf, state.X[lm], obs,
        )

    return jax.vmap(one)(data.sg_pair, data.sg_lm, data.sg_t, data.sg_obs, pack_e)


def _stereo_eval(data: LocalBAData, state: BAState):
    T_e = _onehot_gather(data.st_pose, state.T.shape[0], state.T)

    def one(Twb, lm, obs, is_stereo):
        r3, J3, Jl, Xc = reprojection.stereo_residual_jac(
            Twb, data.Tbc_stereo, data.K_stereo, data.bf, state.X[lm], obs
        )
        row = jnp.where(
            is_stereo, jnp.ones(3, r3.dtype), jnp.asarray([1, 1, 0], r3.dtype)
        )
        return r3 * row, J3 * row[:, None], Jl * row[:, None], Xc[2]

    return jax.vmap(one)(T_e, data.st_lm, data.st_obs, data.st_is_stereo)


def _gp_chain_eval(data: LocalBAData, state: BAState):
    def one(pair):
        i, j = pair[0], pair[1]
        return gp_prior.gp_prior_residual_jac(
            state.T[i], state.v[i], data.times[i],
            state.T[j], state.v[j], data.times[j],
        )

    return jax.vmap(one)(data.gp_pairs)




def _interp_poses(data: LocalBAData, state: BAState, sid_cols, it_sid, it_t):
    """Residual-path variant of _interp_packs: only the interpolated pose
    inverse per unique (structure, timestamp) combo (no Jacobian factor)."""
    i_s = sid_cols[:, 0] // 12
    j_s = sid_cols[:, 12] // 12
    i_u, j_u = i_s[it_sid], j_s[it_sid]
    j_u = jnp.where(j_u == i_u, jnp.minimum(i_u + 1, data.n_poses - 1), j_u)
    eye = jnp.eye(6, dtype=state.T.dtype)

    def one(i, j, t):
        Twb, _ = gp.query_pose_aux(
            state.T[i], state.T[j], state.v[i], state.v[j],
            data.times[i], data.times[j], t, eye, eye,
        )
        return lie.se3_inv(Twb)

    return jax.vmap(one)(i_u, j_u, it_t)


def _mono_gp_residuals(data: LocalBAData, state: BAState):
    """Residual-only async-camera GP evaluation (chi2 path — avoids building
    the Jacobian chains XLA may not fully DCE through vmap)."""
    if data.mg_obs.shape[0] == 0:
        return jnp.zeros((0, 2), data.mg_obs.dtype)
    if data.mg_it is not None:
        Tbw_u = _interp_poses(
            data, state, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t
        )
        Tbw_e = _onehot_gather(data.mg_it, Tbw_u.shape[0], Tbw_u)
        Text_all, K_all = _mono_cam_tables(data, state)
        Text_e = _onehot_gather(data.mg_cam, data.n_ext + 1, Text_all)
        K_e = _onehot_gather(data.mg_cam, data.n_ext + 1, K_all)

        def one(Tbw, Tbc, Kc, lm, obs):
            return reprojection.mono_gp_residual_interp(
                Tbw, Tbc, Kc, state.X[lm], obs
            )

        return jax.vmap(one)(Tbw_e, Text_e, K_e, data.mg_lm, data.mg_obs)

    Text_all, K_all = _mono_cam_tables(data, state)

    def one(pair, lm, cam, t, obs):
        i, j = pair[0], pair[1]
        r, _ = reprojection.mono_gp_residual(
            state.T[i], state.v[i], data.times[i],
            state.T[j], state.v[j], data.times[j],
            t, Text_all[cam], K_all[cam], state.X[lm], obs,
        )
        return r

    return jax.vmap(one)(data.mg_pair, data.mg_lm, data.mg_cam, data.mg_t, data.mg_obs)


def _stereo_gp_residuals(data: LocalBAData, state: BAState):
    if data.sg_obs.shape[0] == 0:
        return jnp.zeros((0, 3), data.sg_obs.dtype)
    if data.sg_it is not None:
        Tbw_u = _interp_poses(
            data, state, data.sg_sid_cols, data.sg_it_sid, data.sg_it_t
        )
        Tbw_e = _onehot_gather(data.sg_it, Tbw_u.shape[0], Tbw_u)

        def one(Tbw, lm, obs):
            return reprojection.stereo_gp_residual_interp(
                Tbw, data.Tbc_stereo, data.K_stereo, data.bf,
                state.X[lm], obs,
            )

        return jax.vmap(one)(Tbw_e, data.sg_lm, data.sg_obs)

    def one(pair, lm, t, obs):
        i, j = pair[0], pair[1]
        eye = jnp.eye(6, dtype=state.T.dtype)
        from ..ops import gp as _gp

        Twb, _ = _gp.query_pose_aux(
            state.T[i], state.T[j], state.v[i], state.v[j],
            data.times[i], data.times[j], t, eye, eye,
        )
        Xb = lie.transform_point(lie.se3_inv(Twb), state.X[lm])
        Xc = lie.transform_point(lie.se3_inv(data.Tbc_stereo), Xb)
        return obs - reprojection.project_stereo(data.K_stereo, data.bf, Xc)

    return jax.vmap(one)(data.sg_pair, data.sg_lm, data.sg_t, data.sg_obs)


def _stereo_residuals(data: LocalBAData, state: BAState):
    T_e = _onehot_gather(data.st_pose, state.T.shape[0], state.T)

    def one(Twb, lm, obs, is_stereo):
        r3, Xc = reprojection.stereo_residual(
            Twb, data.Tbc_stereo, data.K_stereo, data.bf, state.X[lm], obs
        )
        row = jnp.where(
            is_stereo, jnp.ones(3, r3.dtype), jnp.asarray([1, 1, 0], r3.dtype)
        )
        return r3 * row

    return jax.vmap(one)(T_e, data.st_lm, data.st_obs, data.st_is_stereo)


def _gp_chain_residuals(data: LocalBAData, state: BAState):
    def one(pair):
        i, j = pair[0], pair[1]
        return gp_prior.gp_prior_residual(
            state.T[i], state.v[i], data.times[i],
            state.T[j], state.v[j], data.times[j],
        )

    return jax.vmap(one)(data.gp_pairs)


def make_ba_problem(
    data: LocalBAData,
    lvl_m,
    lvl_sg,
    lvl_st,
    huber_on: bool = True,
    ext_active=None,
) -> LMProblem:
    """Build LM closures for the local BA. `ext_active` (Cx,) overrides the
    extrinsic fixed flags (phase-2 refinement)."""
    dtype = data.mg_obs.dtype
    K = data.n_poses
    Cx = data.n_ext
    # Extrinsic vertices occupy 12-wide phantom column groups (cols 6..11 of
    # each group inactive) so every landmark-coupling block is a uniform
    # (3,12) tile and Wt assembles without a column remap. Inactive columns
    # get identity rows in the damped system (same mechanism as fixed
    # vertices), so the Schur solve is unaffected.
    G = K + Cx
    P = 12 * G

    pose_act = (~data.pose_fixed).astype(dtype)  # (K,)
    if ext_active is None:
        ext_act = (~data.ext_fixed).astype(dtype)
    else:
        ext_act = ext_active.astype(dtype)
    phantom = jnp.tile(
        jnp.concatenate([jnp.ones(6, dtype), jnp.zeros(6, dtype)]), Cx
    )
    act_vec = jnp.concatenate(
        [jnp.repeat(pose_act, 12), jnp.repeat(ext_act, 12) * phantom]
    )  # (P,)
    # mg_cam == Cx selects the virtual stereo row (never optimizable):
    # pad with a zero so the per-edge extrinsic mask gather stays in-bounds
    ext_act1 = jnp.concatenate([ext_act, jnp.zeros(1, dtype)])

    act_m = data.mg_valid & lvl_m
    act_sg = data.sg_valid & lvl_sg
    act_st = data.st_valid & lvl_st
    delta_st = jnp.where(
        data.st_is_stereo,
        jnp.asarray(TH_HUBER_STEREO, dtype),
        jnp.asarray(TH_HUBER_MONO, dtype),
    )

    def chi2(state: BAState):
        r_m = _mono_gp_residuals(data, state)
        s = jnp.sum(r_m * r_m, -1) * data.mg_w
        rho0, _ = robust.huber_rho01(s, jnp.asarray(TH_HUBER_MONO, dtype), huber_on)
        c = jnp.sum(jnp.where(act_m, rho0, 0.0))

        r_sg = _stereo_gp_residuals(data, state)
        s = jnp.sum(r_sg * r_sg, -1) * data.sg_w
        rho0, _ = robust.huber_rho01(s, jnp.asarray(TH_HUBER_STEREO, dtype), huber_on)
        c += jnp.sum(jnp.where(act_sg, rho0, 0.0))

        r_st = _stereo_residuals(data, state)
        s = jnp.sum(r_st * r_st, -1) * data.st_w
        rho0, _ = robust.huber_rho01(s, delta_st, huber_on)
        c += jnp.sum(jnp.where(act_st, rho0, 0.0))

        r_g = _gp_chain_residuals(data, state)
        s = jnp.einsum("ei,eij,ej->e", r_g, data.gp_qi_inv, r_g)
        rho0, _ = robust.huber_rho01(
            s, jnp.asarray(TH_HUBER_GP, dtype), data.gp_huber
        )
        c += jnp.sum(jnp.where(data.gp_valid, rho0, 0.0))

        c += jnp.sum(
            jnp.where(data.vel_valid, data.qcinv22 * state.v[:, 2] ** 2, 0.0)
        )

        r_e = jax.vmap(priors.extrinsic_prior_residual)(state.Text, data.R_prior)
        c += jnp.sum(jnp.einsum("ci,cij,cj->c", r_e, data.ext_info, r_e))
        return c

    use_tab = data.lm_blk is not None
    arange12 = jnp.arange(12)

    def linearize(state: BAState):
        L = state.X.shape[0]
        # --- unified pose-Hessian contributions: every edge family reduces
        # to (segments, 30x30 block, 30 column indices) triples; the final
        # Hpp/bp assemble with two dense one-hot contractions instead of
        # scatter-adds.
        seg_H, seg_b, seg_cols = [], [], []
        # --- landmark-coupling blocks, in the exact order of
        # make_landmark_tables: [mono-i | mono-j | mono-ext | sg-i | sg-j | st]
        blk36 = []
        # --- landmark-system rows [Hll 9 | bl 3] in order [mono | sg | st]
        edge12 = []
        # fallback (no gather tables): segment-sum accumulators
        wp_rows, wp_keys = [], []
        We = jnp.zeros((L * Cx, 3, 6), dtype) if (Cx and not use_tab) else None
        Hll = jnp.zeros((L, 3, 3), dtype)
        bl = jnp.zeros((L, 3), dtype)

        def add_seg(Hs, bs, cols):
            """Queue (S,w,w) blocks for the unified Hpp assembly.

            INVARIANT (relied on by the 12-aligned segment-sum below): each
            `cols` row must decompose into 12-wide groups whose entries are
            `base + offset` with `base % 12 == 0` — i.e. cols[:, 0/12/24]
            are 12-aligned group starts and columns are contiguous within
            each group (shorter widths are zero-padded up to 30, and zeros
            satisfy the invariant trivially because the padded values are
            zero). A caller violating this corrupts Hpp silently;
            make_structure_ids asserts it for the table-driven path, and
            the inline cols built here (GP chain :705, extrinsic prior
            :721) are 12*idx + arange by construction."""
            w_ = Hs.shape[1]
            if w_ < 30:
                Hs = jnp.pad(Hs, ((0, 0), (0, 30 - w_), (0, 30 - w_)))
                bs = jnp.pad(bs, ((0, 0), (0, 30 - w_)))
                cols = jnp.pad(cols, ((0, 0), (0, 30 - w_)))
            seg_H.append(Hs)
            seg_b.append(bs)
            seg_cols.append(cols.astype(jnp.int32))

        def seg_reduce(Hblk, bblk, sid, n_sid):
            """Segment reduction as a one-hot matmul (not a scatter)."""
            E, w_ = bblk.shape
            onehot = (sid[None, :] == jnp.arange(n_sid)[:, None]).astype(dtype)
            Hs = jnp.einsum("se,eab->sab", onehot, Hblk)
            bs = onehot @ bblk
            return Hs, bs

        def add_lm(Hll_e, bl_e, lm):
            nonlocal Hll, bl
            E = bl_e.shape[0]
            if use_tab:
                edge12.append(
                    jnp.concatenate([Hll_e.reshape(E, 9), bl_e], axis=1)
                )
            else:
                Hll = Hll + jax.ops.segment_sum(Hll_e, lm, L)
                bl = bl + jax.ops.segment_sum(bl_e, lm, L)

        # ===== async-camera GP mono edges =====
        r, J1, J2, Jl, Jext, Xc = _mono_gp_eval(data, state)
        # NaN-safe masking: padded/invalid edges can hold degenerate geometry
        # (z=0, dt=0) whose residuals are inf/NaN; `where` (not *mask) kills
        # them before any product, since NaN * 0 = NaN.
        m3 = act_m[:, None]
        r = jnp.where(m3, r, 0.0)
        J1 = jnp.where(m3[..., None], J1, 0.0)
        J2 = jnp.where(m3[..., None], J2, 0.0)
        Jl = jnp.where(m3[..., None], Jl, 0.0)
        Jext = jnp.where(m3[..., None], Jext, 0.0)
        s = jnp.sum(r * r, -1) * data.mg_w
        _, rho1 = robust.huber_rho01(s, jnp.asarray(TH_HUBER_MONO, dtype), huber_on)
        w = jnp.where(act_m, data.mg_w * rho1, 0.0)
        i_, j_, c_ = data.mg_pair[:, 0], data.mg_pair[:, 1], data.mg_cam
        # mask fixed vertices (their Jacobian blocks vanish)
        J1 = J1 * pose_act[i_][:, None, None]
        J2 = J2 * pose_act[j_][:, None, None]
        Jext_m = Jext * ext_act1[c_][:, None, None]
        Jp = jnp.concatenate([J1, J2, Jext_m], axis=2)  # (E,2,30)
        JpW = Jp * w[:, None, None]
        Em = Jp.shape[0]
        # Hpp blocks deduplicated by host-precomputed structure id: there
        # are only O(K*Cx) distinct (pose-pair, camera) column sets, and the
        # segment count is encoded in mg_sid_cols' shape (static under jit).
        Hblk = jnp.sum(JpW[:, :, :, None] * Jp[:, :, None, :], axis=1)  # (E,30,30)
        bblk = -jnp.sum(JpW * r[:, :, None], axis=1)  # (E,30)
        Hs, bs = seg_reduce(Hblk, bblk, data.mg_sid, data.mg_sid_cols.shape[0])
        add_seg(Hs, bs, data.mg_sid_cols)
        # landmark coupling + landmark system
        JlW = Jl * w[:, None, None]  # (E,2,3)
        Wblk = jnp.sum(JlW[:, :, :, None] * Jp[:, :, None, :], axis=1)  # (E,3,30)
        if use_tab:
            blk36.append(Wblk[:, :, :12].reshape(Em, 36))
            blk36.append(Wblk[:, :, 12:24].reshape(Em, 36))
            blk36.append(
                jnp.pad(Wblk[:, :, 24:30], ((0, 0), (0, 0), (0, 6))).reshape(Em, 36)
            )
        else:
            wp_rows.append(Wblk[:, :, :12])
            wp_keys.append(data.mg_lm * K + i_)
            wp_rows.append(Wblk[:, :, 12:24])
            wp_keys.append(data.mg_lm * K + j_)
            if Cx:
                # virtual stereo rows (c_ == Cx) carry zero blocks; clamp
                # their key in-bounds rather than alias into lm+1
                We = We + jax.ops.segment_sum(
                    Wblk[:, :, 24:30],
                    data.mg_lm * Cx + jnp.minimum(c_, Cx - 1), L * Cx,
                )
        add_lm(
            jnp.sum(JlW[:, :, :, None] * Jl[:, :, None, :], axis=1),
            -jnp.sum(JlW * r[:, :, None], axis=1),
            data.mg_lm,
        )

        # ===== GP stereo edges =====
        r, J1, J2, Jl, Xc = _stereo_gp_eval(data, state)
        m3 = act_sg[:, None]
        r = jnp.where(m3, r, 0.0)
        J1 = jnp.where(m3[..., None], J1, 0.0)
        J2 = jnp.where(m3[..., None], J2, 0.0)
        Jl = jnp.where(m3[..., None], Jl, 0.0)
        s = jnp.sum(r * r, -1) * data.sg_w
        _, rho1 = robust.huber_rho01(s, jnp.asarray(TH_HUBER_STEREO, dtype), huber_on)
        w = jnp.where(act_sg, data.sg_w * rho1, 0.0)
        i_, j_ = data.sg_pair[:, 0], data.sg_pair[:, 1]
        J1 = J1 * pose_act[i_][:, None, None]
        J2 = J2 * pose_act[j_][:, None, None]
        Jp = jnp.concatenate([J1, J2], axis=2)  # (E,3,24)
        JpW = Jp * w[:, None, None]
        Eg = Jp.shape[0]
        Hblk = jnp.sum(JpW[:, :, :, None] * Jp[:, :, None, :], axis=1)
        bblk = -jnp.sum(JpW * r[:, :, None], axis=1)
        Hs, bs = seg_reduce(Hblk, bblk, data.sg_sid, data.sg_sid_cols.shape[0])
        add_seg(Hs, bs, data.sg_sid_cols)
        JlW = Jl * w[:, None, None]
        Wblk = jnp.sum(JlW[:, :, :, None] * Jp[:, :, None, :], axis=1)
        if use_tab:
            blk36.append(Wblk[:, :, :12].reshape(Eg, 36))
            blk36.append(Wblk[:, :, 12:24].reshape(Eg, 36))
        else:
            wp_rows.append(Wblk[:, :, :12])
            wp_keys.append(data.sg_lm * K + i_)
            wp_rows.append(Wblk[:, :, 12:24])
            wp_keys.append(data.sg_lm * K + j_)
        add_lm(
            jnp.sum(JlW[:, :, :, None] * Jl[:, :, None, :], axis=1),
            -jnp.sum(JlW * r[:, :, None], axis=1),
            data.sg_lm,
        )

        # ===== stereo-camera KF edges =====
        r, J3, Jl, _ = _stereo_eval(data, state)
        m3 = act_st[:, None]
        r = jnp.where(m3, r, 0.0)
        J3 = jnp.where(m3[..., None], J3, 0.0)
        Jl = jnp.where(m3[..., None], Jl, 0.0)
        s = jnp.sum(r * r, -1) * data.st_w
        _, rho1 = robust.huber_rho01(s, delta_st, huber_on)
        w = jnp.where(act_st, data.st_w * rho1, 0.0)
        p_ = data.st_pose
        J3 = J3 * pose_act[p_][:, None, None]
        JpW = J3 * w[:, None, None]
        Es = J3.shape[0]
        Hblk = jnp.sum(JpW[:, :, :, None] * J3[:, :, None, :], axis=1)
        bblk = -jnp.sum(JpW * r[:, :, None], axis=1)
        Hs, bs = seg_reduce(Hblk, bblk, p_, K)
        colK = (12 * jnp.arange(K)[:, None] + arange12[None, :]).astype(jnp.int32)
        add_seg(Hs, bs, colK)
        JlW = Jl * w[:, None, None]
        Wblk = jnp.sum(JlW[:, :, :, None] * J3[:, :, None, :], axis=1)
        if use_tab:
            blk36.append(Wblk.reshape(Es, 36))
        else:
            wp_rows.append(Wblk)
            wp_keys.append(data.st_lm * K + p_)
        add_lm(
            jnp.sum(JlW[:, :, :, None] * Jl[:, :, None, :], axis=1),
            -jnp.sum(JlW * r[:, :, None], axis=1),
            data.st_lm,
        )

        # ===== GP prior chain (each edge its own segment) =====
        r, J1, J2 = _gp_chain_eval(data, state)
        mg3 = data.gp_valid[:, None]
        r = jnp.where(mg3, r, 0.0)
        J1 = jnp.where(mg3[..., None], J1, 0.0)
        J2 = jnp.where(mg3[..., None], J2, 0.0)
        s = jnp.einsum("ei,eij,ej->e", r, data.gp_qi_inv, r)
        _, rho1 = robust.huber_rho01(s, jnp.asarray(TH_HUBER_GP, dtype), data.gp_huber)
        wg = jnp.where(data.gp_valid, rho1, 0.0)
        i_, j_ = data.gp_pairs[:, 0], data.gp_pairs[:, 1]
        J1 = J1 * pose_act[i_][:, None, None]
        J2 = J2 * pose_act[j_][:, None, None]
        Jp = jnp.concatenate([J1, J2], axis=2)  # (Ng,12,24)
        JW = jnp.sum(
            (data.gp_qi_inv * wg[:, None, None])[:, :, :, None] * Jp[:, None, :, :],
            axis=2,
        )  # Omega J (E,12,24)
        cols = jnp.concatenate(
            [
                12 * i_[:, None] + arange12[None, :],
                12 * j_[:, None] + arange12[None, :],
            ],
            axis=1,
        )
        Hblk = jnp.sum(JW[:, :, :, None] * Jp[:, :, None, :], axis=1)
        bblk = -jnp.sum(JW * r[:, :, None], axis=1)
        add_seg(Hblk, bblk, cols)

        # ===== extrinsic priors =====
        r_e = jax.vmap(priors.extrinsic_prior_residual)(state.Text, data.R_prior)
        J_e = jax.vmap(priors.extrinsic_prior_jac)(state.Text, data.R_prior)
        J_e = J_e * ext_act[:, None, None]
        JW_e = jnp.einsum("cij,cjk->cik", data.ext_info, J_e)
        colE = 12 * K + 12 * jnp.arange(Cx)[:, None] + jnp.arange(6)[None, :]
        add_seg(
            jnp.einsum("cri,crj->cij", JW_e, J_e),
            -jnp.einsum("cri,cr->ci", JW_e, r_e),
            colE,
        )

        # ===== unified Hpp/bp assembly =====
        # Every segment block is made of 12-aligned unit sub-blocks
        # (make_structure_ids emits only 12-aligned column starts; padded
        # positions point at column 0 with zero values), so the (S,30,30)
        # blocks land on the (G,G) grid of 12x12 unit pairs with one
        # segment-sum instead of two dense (S,30,P) one-hot contractions.
        # Measured (cost_analysis, 50 KF / 5k pt headline shape): 32.0 ->
        # 22.4 GFLOP per LM iteration, wall-time neutral at this shape —
        # the win is that segment-sum cost is independent of P, where the
        # one-hot M/A intermediates grew as (S,30,P) with the window size
        # (bLarge 25-KF windows, merged fixed sets).
        H_all = jnp.concatenate(seg_H, axis=0)    # (S,30,30)
        b_all = jnp.concatenate(seg_b, axis=0)    # (S,30)
        cols_all = jnp.concatenate(seg_cols, axis=0)  # (S,30)
        S_tot = H_all.shape[0]
        H36 = jnp.pad(H_all, ((0, 0), (0, 6), (0, 6)))
        b36 = jnp.pad(b_all, ((0, 0), (0, 6)))
        units = cols_all[:, ::12] // 12           # (S,3) unit per sub-block
        subs = H36.reshape(S_tot, 3, 12, 3, 12).transpose(0, 1, 3, 2, 4)
        keys = (units[:, :, None] * G + units[:, None, :]).reshape(-1)
        Hu = jax.ops.segment_sum(subs.reshape(S_tot * 9, 12, 12), keys, G * G)
        Hpp = Hu.reshape(G, G, 12, 12).transpose(0, 2, 1, 3).reshape(P, P)
        bu = jax.ops.segment_sum(
            b36.reshape(S_tot * 3, 12), units.reshape(-1), G
        )
        bp = bu.reshape(P)

        # ===== velocity edges (diagonal; no scatter) =====
        wv = jnp.where(data.vel_valid, data.qcinv22, 0.0) * pose_act
        u8 = (arange12 == 8).astype(dtype)
        velvec = jnp.concatenate(
            [(wv[:, None] * u8[None, :]).reshape(-1), jnp.zeros(12 * Cx, dtype)]
        )
        Hpp = Hpp + jnp.eye(P, dtype=dtype) * velvec[None, :]
        bvel = jnp.concatenate(
            [(-(wv * state.v[:, 2])[:, None] * u8[None, :]).reshape(-1),
             jnp.zeros(12 * Cx, dtype)]
        )
        bp = bp + bvel

        # ===== landmark side =====
        if use_tab:
            blk_vals = jnp.concatenate(blk36, axis=0)  # (B,36)
            oh = (
                (data.lm_blk_g[:, :, None] == jnp.arange(G, dtype=jnp.int32))
                & data.lm_blk_valid[:, :, None]
            ).astype(dtype)  # (L,D,G)
            # produce Wt directly in its (L,3,P) layout: the old
            # (L,G,36)-then-transpose form materialized an extra 40 MB
            # round-trip per iteration at the headline shape
            gb = blk_vals[data.lm_blk].reshape(L, -1, 3, 12)  # (L,D,3,12)
            Wt = jnp.einsum("ldak,ldg->lagk", gb, oh).reshape(L, 3, P)
            ev = jnp.concatenate(edge12, axis=0)  # (E_tot,12)
            ge = ev[data.lm_edge] * data.lm_edge_valid[..., None].astype(dtype)
            se = jnp.sum(ge, axis=1)  # (L,12)
            Hll = se[:, :9].reshape(L, 3, 3)
            bl = se[:, 9:12]
        else:
            Wp = jax.ops.segment_sum(
                jnp.concatenate(wp_rows, axis=0), jnp.concatenate(wp_keys), L * K
            )
            Wt_pose = (
                Wp.reshape(L, K, 3, 12).transpose(0, 2, 1, 3).reshape(L, 3, 12 * K)
            )
            if Cx:
                We_pad = jnp.pad(
                    We.reshape(L, Cx, 3, 6), ((0, 0), (0, 0), (0, 0), (0, 6))
                )
                Wt_ext = We_pad.transpose(0, 2, 1, 3).reshape(L, 3, 12 * Cx)
                Wt = jnp.concatenate([Wt_pose, Wt_ext], axis=2)
            else:
                Wt = Wt_pose
        return (Hpp, bp, Wt, Hll, bl)

    def max_abs_diag(lin):
        Hpp, bp, Wt, Hll, bl = lin
        m1 = jnp.max(jnp.abs(jnp.diagonal(Hpp)) * act_vec)
        m2 = jnp.max(jnp.abs(jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(Hll)))
        return jnp.maximum(m1, m2)

    def solve(lin, lam):
        Hpp, bp, Wt, Hll, bl = lin
        L = Hll.shape[0]
        eye3 = jnp.eye(3, dtype=dtype)
        Hll_inv = _inv3x3(Hll + lam * eye3[None])
        Y = jnp.einsum("lab,lbp->lap", Hll_inv, Wt)  # (L,3,P)
        # diag via eye-multiply (no scatter); inactive/phantom columns get
        # identity rows
        Hs = (
            Hpp
            + jnp.eye(P, dtype=dtype) * (lam * act_vec + (1.0 - act_vec))[None, :]
            - jnp.einsum("lap,laq->pq", Y, Wt)
        )
        bs = bp - jnp.einsum("lap,la->p", Y, bl)
        Lc, lower = jax.scipy.linalg.cho_factor(Hs)
        dxp = jax.scipy.linalg.cho_solve((Lc, lower), bs)
        dxl = jnp.einsum("lab,lb->la", Hll_inv, bl - jnp.einsum("lap,p->la", Wt, dxp))
        dot_xx = dxp @ dxp + jnp.sum(dxl * dxl)
        dot_xb = dxp @ bp + jnp.sum(dxl * bl)
        return (dxp, dxl), dot_xx, dot_xb

    def retract(state: BAState, dx):
        dxp, dxl = dx
        dpose = dxp[: 12 * K].reshape(K, 12)
        dext = dxp[12 * K :].reshape(Cx, 12)[:, :6]  # drop phantom cols
        T = jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.T, dpose[:, :6])
        Text = jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.Text, dext)
        return BAState(T=T, v=state.v + dpose[:, 6:], Text=Text, X=state.X + dxl)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def _sorted_segment(idx):
    """Static pre-sort for a segment-id array, so `segment_sum` runs with
    `indices_are_sorted=True` after one permutation gather. The ids are
    problem statics, so the permutation is computed once on the host.
    Returns seg(vals, n) closing over (perm, sorted_ids); falls back to the
    plain unsorted scatter if the ids are a tracer (problem built under
    jit)."""
    if isinstance(idx, jax.core.Tracer):
        def seg(vals, n):
            return jax.ops.segment_sum(vals, idx, n)

        return seg
    idx_h = np.asarray(idx)
    perm = jnp.asarray(np.argsort(idx_h, kind="stable"))
    sids = jnp.asarray(np.sort(idx_h))

    def seg(vals, n):
        return jax.ops.segment_sum(vals[perm], sids, n, indices_are_sorted=True)

    return seg


def make_ba_problem_pcg(
    data: LocalBAData,
    lvl_m,
    lvl_sg,
    lvl_st,
    huber_on: bool = True,
    ext_active=None,
    pcg_iters: int = 200,
    pcg_tol: float = 1e-10,
    precond: str = "jacobi",
) -> LMProblem:
    """Matrix-free Schur-complement BA for at-scale keyframe counts (the
    rebuild of LinearSolverEigen's sparse Cholesky used by the reference's
    GLOBAL BA, Optimizer.cc:70): neither the PxP reduced pose system nor the
    (L,3,P) landmark-coupling tensor is ever materialized. The Schur product

        S x = Hpp x - W Hll^-1 W^T x

    evaluates edge-wise: Hpp x as J_e^T w_e (J_e x[cols_e]) with
    segment-sums, W^T x by reducing Jl_e^T w_e (J_e x[cols_e]) per landmark,
    and the back-map W z by gathering z at each edge's landmark.
    Preconditioner: inverted per-vertex 12x12 (pose) / 6x6 (extrinsic)
    diagonal blocks of Hpp (block-Jacobi). Memory is O(E + L + K) — a
    5000-KF global BA fits where the dense path would need a 60k x 60k
    matrix."""
    dtype = data.mg_obs.dtype
    K = data.n_poses
    Cx = data.n_ext

    pose_act = (~data.pose_fixed).astype(dtype)
    if ext_active is None:
        ext_act = (~data.ext_fixed).astype(dtype)
    else:
        ext_act = ext_active.astype(dtype)
    # zero pad: mg_cam == Cx is the non-optimizable virtual stereo row
    ext_act1 = jnp.concatenate([ext_act, jnp.zeros(1, dtype)])

    act_m = data.mg_valid & lvl_m
    act_sg = data.sg_valid & lvl_sg
    act_st = data.st_valid & lvl_st
    delta_st = jnp.where(
        data.st_is_stereo,
        jnp.asarray(TH_HUBER_STEREO, dtype),
        jnp.asarray(TH_HUBER_MONO, dtype),
    )

    # statically pre-sorted segment reducers, one per scatter axis (the
    # Schur/Hx products are scatter-rate-bound; see _sorted_segment)
    seg_im = _sorted_segment(data.mg_pair[:, 0])
    seg_jm = _sorted_segment(data.mg_pair[:, 1])
    seg_cm = _sorted_segment(data.mg_cam)
    seg_ig = _sorted_segment(data.sg_pair[:, 0])
    seg_jg = _sorted_segment(data.sg_pair[:, 1])
    seg_p = _sorted_segment(data.st_pose)
    seg_ip = _sorted_segment(data.gp_pairs[:, 0])
    seg_jp = _sorted_segment(data.gp_pairs[:, 1])
    seg_lmm = _sorted_segment(data.mg_lm)
    seg_lmg = _sorted_segment(data.sg_lm)
    seg_lms = _sorted_segment(data.st_lm)

    # chi2 is identical to the dense path's
    _dense = make_ba_problem(data, lvl_m, lvl_sg, lvl_st, huber_on=huber_on,
                             ext_active=ext_active)
    chi2 = _dense.chi2

    def linearize(state: BAState):
        L = state.X.shape[0]
        Hll = jnp.zeros((L, 3, 3), dtype)
        bl = jnp.zeros((L, 3), dtype)
        bp12 = jnp.zeros((K, 12), dtype)
        bext = jnp.zeros((Cx, 6), dtype) if Cx else jnp.zeros((0, 6), dtype)
        D12 = jnp.zeros((K, 12, 12), dtype)
        Dext = jnp.zeros((Cx, 6, 6), dtype) if Cx else jnp.zeros((0, 6, 6), dtype)

        # ===== async-camera GP mono edges =====
        r_m, J1m, J2m, Jlm, Jem, _ = _mono_gp_eval(data, state)
        m3 = act_m[:, None]
        r_m = jnp.where(m3, r_m, 0.0)
        J1m = jnp.where(m3[..., None], J1m, 0.0)
        J2m = jnp.where(m3[..., None], J2m, 0.0)
        Jlm = jnp.where(m3[..., None], Jlm, 0.0)
        Jem = jnp.where(m3[..., None], Jem, 0.0)
        s = jnp.sum(r_m * r_m, -1) * data.mg_w
        _, rho1 = robust.huber_rho01(s, jnp.asarray(TH_HUBER_MONO, dtype), huber_on)
        w_m = jnp.where(act_m, data.mg_w * rho1, 0.0)
        im, jm, cm = data.mg_pair[:, 0], data.mg_pair[:, 1], data.mg_cam
        J1m = J1m * pose_act[im][:, None, None]
        J2m = J2m * pose_act[jm][:, None, None]
        Jem = Jem * ext_act1[cm][:, None, None]
        wr = w_m[:, None] * r_m
        bp12 = bp12 - seg_im(
            jnp.einsum("erc,er->ec", J1m, wr), K
        ) - seg_jm(jnp.einsum("erc,er->ec", J2m, wr), K)
        if Cx:
            bext = bext - seg_cm(
                jnp.einsum("erc,er->ec", Jem, wr), Cx
            )
        D12 = D12 + seg_im(
            jnp.einsum("eri,e,erj->eij", J1m, w_m, J1m), K
        ) + seg_jm(
            jnp.einsum("eri,e,erj->eij", J2m, w_m, J2m), K
        )
        if Cx:
            Dext = Dext + seg_cm(
                jnp.einsum("eri,e,erj->eij", Jem, w_m, Jem), Cx
            )
        JlWm = Jlm * w_m[:, None, None]
        Hll = Hll + seg_lmm(
            jnp.einsum("eri,erj->eij", JlWm, Jlm), L
        )
        bl = bl - seg_lmm(
            jnp.einsum("eri,er->ei", JlWm, r_m), L
        )

        # ===== GP stereo edges =====
        r_g, J1g, J2g, Jlg, _ = _stereo_gp_eval(data, state)
        m3 = act_sg[:, None]
        r_g = jnp.where(m3, r_g, 0.0)
        J1g = jnp.where(m3[..., None], J1g, 0.0)
        J2g = jnp.where(m3[..., None], J2g, 0.0)
        Jlg = jnp.where(m3[..., None], Jlg, 0.0)
        s = jnp.sum(r_g * r_g, -1) * data.sg_w
        _, rho1 = robust.huber_rho01(s, jnp.asarray(TH_HUBER_STEREO, dtype), huber_on)
        w_g = jnp.where(act_sg, data.sg_w * rho1, 0.0)
        ig, jg = data.sg_pair[:, 0], data.sg_pair[:, 1]
        J1g = J1g * pose_act[ig][:, None, None]
        J2g = J2g * pose_act[jg][:, None, None]
        wr = w_g[:, None] * r_g
        bp12 = bp12 - seg_ig(
            jnp.einsum("erc,er->ec", J1g, wr), K
        ) - seg_jg(jnp.einsum("erc,er->ec", J2g, wr), K)
        D12 = D12 + seg_ig(
            jnp.einsum("eri,e,erj->eij", J1g, w_g, J1g), K
        ) + seg_jg(
            jnp.einsum("eri,e,erj->eij", J2g, w_g, J2g), K
        )
        JlWg = Jlg * w_g[:, None, None]
        Hll = Hll + seg_lmg(
            jnp.einsum("eri,erj->eij", JlWg, Jlg), L
        )
        bl = bl - seg_lmg(
            jnp.einsum("eri,er->ei", JlWg, r_g), L
        )

        # ===== stereo-camera KF edges =====
        r_s, J3, Jls, _ = _stereo_eval(data, state)
        m3 = act_st[:, None]
        r_s = jnp.where(m3, r_s, 0.0)
        J3 = jnp.where(m3[..., None], J3, 0.0)
        Jls = jnp.where(m3[..., None], Jls, 0.0)
        s = jnp.sum(r_s * r_s, -1) * data.st_w
        _, rho1 = robust.huber_rho01(s, delta_st, huber_on)
        w_s = jnp.where(act_st, data.st_w * rho1, 0.0)
        p_ = data.st_pose
        J3 = J3 * pose_act[p_][:, None, None]
        wr = w_s[:, None] * r_s
        bp12 = bp12 - seg_p(jnp.einsum("erc,er->ec", J3, wr), K)
        D12 = D12 + seg_p(
            jnp.einsum("eri,e,erj->eij", J3, w_s, J3), K
        )
        JlWs = Jls * w_s[:, None, None]
        Hll = Hll + seg_lms(
            jnp.einsum("eri,erj->eij", JlWs, Jls), L
        )
        bl = bl - seg_lms(
            jnp.einsum("eri,er->ei", JlWs, r_s), L
        )

        # ===== GP prior chain =====
        r_p, J1p, J2p = _gp_chain_eval(data, state)
        mg3 = data.gp_valid[:, None]
        r_p = jnp.where(mg3, r_p, 0.0)
        J1p = jnp.where(mg3[..., None], J1p, 0.0)
        J2p = jnp.where(mg3[..., None], J2p, 0.0)
        s = jnp.einsum("ei,eij,ej->e", r_p, data.gp_qi_inv, r_p)
        _, rho1 = robust.huber_rho01(s, jnp.asarray(TH_HUBER_GP, dtype), data.gp_huber)
        wg = jnp.where(data.gp_valid, rho1, 0.0)
        ip, jp = data.gp_pairs[:, 0], data.gp_pairs[:, 1]
        J1p = J1p * pose_act[ip][:, None, None]
        J2p = J2p * pose_act[jp][:, None, None]
        Om = data.gp_qi_inv * wg[:, None, None]  # (Ng,12,12)
        OJ1 = jnp.einsum("eab,ebc->eac", Om, J1p)
        OJ2 = jnp.einsum("eab,ebc->eac", Om, J2p)
        bp12 = bp12 - seg_ip(
            jnp.einsum("eab,ea->eb", OJ1, r_p), K
        ) - seg_jp(jnp.einsum("eab,ea->eb", OJ2, r_p), K)
        D12 = D12 + seg_ip(
            jnp.einsum("eab,eac->ebc", OJ1, J1p), K
        ) + seg_jp(jnp.einsum("eab,eac->ebc", OJ2, J2p), K)

        # ===== velocity edges (diagonal) =====
        wv = jnp.where(data.vel_valid, data.qcinv22, 0.0) * pose_act
        u8 = (jnp.arange(12) == 8).astype(dtype)
        D12 = D12 + jnp.eye(12, dtype=dtype)[None] * (wv[:, None] * u8[None, :])[:, None, :]
        bp12 = bp12 - (wv * state.v[:, 2])[:, None] * u8[None, :]

        # ===== extrinsic priors =====
        if Cx:
            r_e = jax.vmap(priors.extrinsic_prior_residual)(state.Text, data.R_prior)
            J_e = jax.vmap(priors.extrinsic_prior_jac)(state.Text, data.R_prior)
            J_e = J_e * ext_act[:, None, None]
            JW_e = jnp.einsum("cij,cjk->cik", data.ext_info, J_e)
            Hext_prior = jnp.einsum("cri,crj->cij", JW_e, J_e)
            Dext = Dext + Hext_prior
            bext = bext - jnp.einsum("cri,cr->ci", JW_e, r_e)
        else:
            Hext_prior = jnp.zeros((0, 6, 6), dtype)

        edges = (
            (J1m, J2m, Jem, Jlm, w_m, im, jm, cm, data.mg_lm),
            (J1g, J2g, Jlg, w_g, ig, jg, data.sg_lm),
            (J3, Jls, w_s, p_, data.st_lm),
            (J1p, J2p, Om, ip, jp),
        )
        return edges, Hll, bl, bp12, bext, D12, Dext, wv, Hext_prior

    def max_abs_diag(lin):
        edges, Hll, bl, bp12, bext, D12, Dext, wv, _ = lin
        m1 = jnp.max(
            jnp.abs(jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(D12))
            * pose_act[:, None]
        )
        m2 = jnp.max(jnp.abs(jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(Hll)))
        if Cx:
            m3 = jnp.max(
                jnp.abs(jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(Dext))
                * ext_act[:, None]
            )
            m1 = jnp.maximum(m1, m3)
        return jnp.maximum(m1, m2)

    def solve(lin, lam, x0=None):
        """`x0=(x12, xe)` optionally warm-starts the CG iteration (initial
        residual b - S x0 instead of b). The generic LM driver always calls
        solve(lin, lam) — cold start, reference-equivalent; warm starting
        across chained LM iterations is a deployment option measured in
        examples/profile_pcg.py."""
        edges, Hll, bl, bp12, bext, D12, Dext, wv, _ext_prior_H = lin
        (J1m, J2m, Jem, Jlm, w_m, im, jm, cm, lm_m) = edges[0]
        (J1g, J2g, Jlg, w_g, ig, jg, lm_g) = edges[1]
        (J3, Jls, w_s, p_, lm_s) = edges[2]
        (J1p, J2p, Om, ip, jp) = edges[3]
        L = Hll.shape[0]
        eye3 = jnp.eye(3, dtype=dtype)
        Hll_inv = _inv3x3(Hll + lam * eye3[None])

        damp12 = (lam * pose_act + (1.0 - pose_act))  # (K,)
        dampe = (lam * ext_act + (1.0 - ext_act)) if Cx else jnp.zeros(0, dtype)

        def edge_u(xp, xe):
            """Per-edge Jp x products for the three landmark families."""
            u_m = (
                jnp.einsum("erc,ec->er", J1m, xp[im])
                + jnp.einsum("erc,ec->er", J2m, xp[jm])
            )
            if Cx:
                u_m = u_m + jnp.einsum("erc,ec->er", Jem, xe[cm])
            u_g = jnp.einsum("erc,ec->er", J1g, xp[ig]) + jnp.einsum(
                "erc,ec->er", J2g, xp[jg]
            )
            u_s = jnp.einsum("erc,ec->er", J3, xp[p_])
            return u_m, u_g, u_s

        def scatter_back(v_m, v_g, v_s, K_, Cx_):
            """J^T v accumulation back onto vertices (v already weighted)."""
            g12 = (
                seg_im(jnp.einsum("erc,er->ec", J1m, v_m), K_)
                + seg_jm(jnp.einsum("erc,er->ec", J2m, v_m), K_)
                + seg_ig(jnp.einsum("erc,er->ec", J1g, v_g), K_)
                + seg_jg(jnp.einsum("erc,er->ec", J2g, v_g), K_)
                + seg_p(jnp.einsum("erc,er->ec", J3, v_s), K_)
            )
            ge = (
                seg_cm(jnp.einsum("erc,er->ec", Jem, v_m), Cx_)
                if Cx_
                else jnp.zeros((0, 6), dtype)
            )
            return g12, ge

        def Wt_x(xp, xe):
            """W^T x: per-landmark 3-vector."""
            u_m, u_g, u_s = edge_u(xp, xe)
            y = (
                seg_lmm(
                    jnp.einsum("eri,er->ei", Jlm, w_m[:, None] * u_m), L
                )
                + seg_lmg(
                    jnp.einsum("eri,er->ei", Jlg, w_g[:, None] * u_g), L
                )
                + seg_lms(
                    jnp.einsum("eri,er->ei", Jls, w_s[:, None] * u_s), L
                )
            )
            return y

        def W_z(z):
            """W z: per-vertex accumulation of Jp^T w Jl z[lm]."""
            v_m = w_m[:, None] * jnp.einsum("eri,ei->er", Jlm, z[lm_m])
            v_g = w_g[:, None] * jnp.einsum("eri,ei->er", Jlg, z[lm_g])
            v_s = w_s[:, None] * jnp.einsum("eri,ei->er", Jls, z[lm_s])
            return scatter_back(v_m, v_g, v_s, K, Cx)

        def Sx(xp, xe):
            """Schur-complement product S x (pose+extrinsic blocks).

            The weighted edge products w (J x) are computed ONCE and feed
            both the Hpp x scatter and the W^T x landmark reduction (the
            two consumers below) — one pass over the edge arrays instead of
            two per CG iteration."""
            u_m, u_g, u_s = edge_u(xp, xe)
            wu_m = w_m[:, None] * u_m
            wu_g = w_g[:, None] * u_g
            wu_s = w_s[:, None] * u_s
            g12, ge = scatter_back(wu_m, wu_g, wu_s, K, Cx)
            # GP chain (no landmark part, full 12x12 information)
            t = jnp.einsum("eab,eb->ea", J1p, xp[ip]) + jnp.einsum(
                "eab,eb->ea", J2p, xp[jp]
            )
            Ot = jnp.einsum("eab,eb->ea", Om, t)
            g12 = g12 + seg_ip(
                jnp.einsum("eab,ea->eb", J1p, Ot), K
            ) + seg_jp(jnp.einsum("eab,ea->eb", J2p, Ot), K)
            # velocity diagonal
            g12 = g12 + (wv * xp[:, 8])[:, None] * (jnp.arange(12) == 8).astype(dtype)[None, :]
            # extrinsic prior lives in Dext already only for precond; its
            # Hessian contribution must be part of Sx too
            if Cx:
                ge = ge + jnp.einsum("cij,cj->ci", _ext_prior_H, xe)
            # Schur correction (reuses the weighted edge products above)
            y = (
                seg_lmm(
                    jnp.einsum("eri,er->ei", Jlm, wu_m), L
                )
                + seg_lmg(
                    jnp.einsum("eri,er->ei", Jlg, wu_g), L
                )
                + seg_lms(
                    jnp.einsum("eri,er->ei", Jls, wu_s), L
                )
            )
            z = jnp.einsum("lab,lb->la", Hll_inv, y)
            c12, ce = W_z(z)
            g12 = g12 - c12 + damp12[:, None] * xp
            if Cx:
                ge = ge - ce + dampe[:, None] * xe
            return g12, ge

        # right-hand side: bs = bp - W Hll^-1 bl
        z_b = jnp.einsum("lab,lb->la", Hll_inv, bl)
        c12, ce = W_z(z_b)
        bs12 = bp12 - c12
        bse = bext - ce if Cx else bext

        def _schur_diag_sub(Jp, Jl, w, lm_idx, seg, n, d):
            A = jnp.einsum("eri,e,erj->eij", Jp, w, Jl)  # (E, d, 3)
            AH = jnp.einsum("eab,ebc->eac", A, Hll_inv[lm_idx])
            C = jnp.einsum("eac,edc->ead", AH, A)  # (E, d, d)
            return jax.ops.segment_sum(C, seg, n)

        if precond == "jacobi":
            Dblk = D12
        else:
            # Schur-Jacobi (Ceres SCHUR_JACOBI): the block diagonal of S
            # itself — Hpp's diagonal blocks minus each edge's W Hll^-1 W^T
            # contribution (per-edge approximation, exact when a
            # (pose, landmark) pair is observed by a single edge). Measured
            # on-chip at 2000 KF / 10k pts: cuts CG iterations only 31 -> 29
            # while its (E,12,12) scatter setup costs more than it saves
            # (162 vs 156 ms/LM-iter) — hence plain Jacobi is the default.
            # (A chain-segment block preconditioner capturing the GP-prior
            # cross blocks was also measured: no iteration reduction at all;
            # the conditioning is landmark-coupling-, not chain-, limited.)
            Dblk = D12 - (
                _schur_diag_sub(J1m, Jlm, w_m, lm_m, im, K, 12)
                + _schur_diag_sub(J2m, Jlm, w_m, lm_m, jm, K, 12)
                + _schur_diag_sub(J1g, Jlg, w_g, lm_g, ig, K, 12)
                + _schur_diag_sub(J2g, Jlg, w_g, lm_g, jg, K, 12)
                + _schur_diag_sub(J3, Jls, w_s, lm_s, p_, K, 12)
            )
        Dblk = Dblk + jnp.eye(12, dtype=dtype)[None] * damp12[:, None, None]
        P12 = jnp.linalg.inv(Dblk)

        def _p12(r12):
            return jnp.einsum("kab,kb->ka", P12, r12)

        if Cx:
            Ce = (
                _schur_diag_sub(Jem, Jlm, w_m, lm_m, cm, Cx, 6)
                if precond != "jacobi"
                else jnp.zeros((Cx, 6, 6), dtype)
            )
            Pe = jnp.linalg.inv(
                Dext - Ce + jnp.eye(6, dtype=dtype)[None] * dampe[:, None, None]
            )
        else:
            Pe = jnp.zeros((0, 6, 6), dtype)

        def apply_precond(r12, re):
            return (
                _p12(r12),
                jnp.einsum("cab,cb->ca", Pe, re) if Cx else re,
            )

        def dot(a12, ae, b12, be):
            d = jnp.sum(a12 * b12)
            if Cx:
                d = d + jnp.sum(ae * be)
            return d

        if x0 is None:
            x12 = jnp.zeros((K, 12), dtype)
            xe = jnp.zeros((Cx, 6), dtype)
            r12, re = bs12, bse
        else:
            x12, xe = x0
            Sx12, Sxe = Sx(x12, xe)
            r12 = bs12 - Sx12
            re = bse - Sxe if Cx else bse
        z12, ze = apply_precond(r12, re)
        p12, pe = z12, ze
        rz = dot(r12, re, z12, ze)
        bnorm = jnp.maximum(dot(bs12, bse, bs12, bse), jnp.asarray(1e-30, dtype))

        def body(c):
            x12, xe, r12, re, p12, pe, rz, it = c
            Hp12, Hpe = Sx(p12, pe)
            alpha = rz / jnp.maximum(
                dot(p12, pe, Hp12, Hpe), jnp.asarray(1e-30, dtype)
            )
            x12n = x12 + alpha * p12
            xen = xe + alpha * pe
            r12n = r12 - alpha * Hp12
            ren = re - alpha * Hpe
            z12n, zen = apply_precond(r12n, ren)
            rz_new = dot(r12n, ren, z12n, zen)
            beta = rz_new / jnp.maximum(rz, jnp.asarray(1e-30, dtype))
            return (
                x12n, xen, r12n, ren, z12n + beta * p12, zen + beta * pe,
                rz_new, it + 1,
            )

        def cond(c):
            x12, xe, r12, re, *_, it = c
            return (it < pcg_iters) & (dot(r12, re, r12, re) > pcg_tol * bnorm)

        x12, xe, r12_f, re_f, _, _, _, it_f = jax.lax.while_loop(
            cond, body, (x12, xe, r12, re, p12, pe, rz, 0)
        )
        if _PCG_DEBUG:
            jax.debug.print(
                "ba-pcg iters={it} rel_res={rr:.3e}",
                it=it_f, rr=dot(r12_f, re_f, r12_f, re_f) / bnorm,
            )

        # landmark back-substitution
        y = Wt_x(x12, xe)
        dxl = jnp.einsum("lab,lb->la", Hll_inv, bl - y)
        dot_xx = jnp.sum(x12 * x12) + jnp.sum(dxl * dxl)
        dot_xb = jnp.sum(x12 * bp12) + jnp.sum(dxl * bl)
        if Cx:
            dot_xx = dot_xx + jnp.sum(xe * xe)
            dot_xb = dot_xb + jnp.sum(xe * bext)
        return (x12, xe, dxl), dot_xx, dot_xb

    def retract(state: BAState, dx):
        dxp, dxe, dxl = dx
        T = jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.T, dxp[:, :6])
        Text = (
            jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.Text, dxe)
            if Cx
            else state.Text
        )
        return BAState(T=T, v=state.v + dxp[:, 6:], Text=Text, X=state.X + dxl)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def global_ba_pcg(data: LocalBAData, state: BAState, num_iterations: int = 10):
    """global_ba with the matrix-free PCG backend — same semantics, O(E)
    memory, for keyframe counts where the dense reduced system is out of
    reach (VERDICT r2 item 5 / Optimizer.cc:70 LinearSolverEigen)."""
    problem = make_ba_problem_pcg(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True
    )
    return lm_optimize(problem, state, num_iterations, lambda_init=1e-5)


class LocalBAResult(NamedTuple):
    state: BAState
    ok: jax.Array            # divergence guard passed
    err_initial: jax.Array
    err_final: jax.Array
    erase_m: jax.Array       # outlier masks to erase (per edge type)
    erase_sg: jax.Array
    erase_st: jax.Array


def local_gp_ba(
    data: LocalBAData,
    state: BAState,
    b_large: bool = False,
    b_extrinsic: bool = False,
    ext_obs_count=None,
    ext_min_obs: int = 50,
):
    """Full LocalGPBA schedule (Optimizer.cc:1218-1432):

    optimize(10) with extrinsics fixed; optionally unfix extrinsics with
    >= 50 observations and optimize(opt_it = 10 or 4 if bLarge); detect
    outlier observations by chi2/depth; divergence guard
    `2*err < err_end or NaN -> abort` (skipped when bLarge).
    """
    lvl = (data.mg_valid, data.sg_valid, data.st_valid)
    lambda_init = 1e-2 if b_large else 1.0
    problem = make_ba_problem(data, *lvl, huber_on=True)
    err_initial = problem.chi2(state)
    new_state, stats = lm_optimize(problem, state, 10, lambda_init=lambda_init)

    if b_extrinsic:
        thresh = ext_min_obs
        counts = (
            ext_obs_count
            if ext_obs_count is not None
            else jax.ops.segment_sum(
                data.mg_valid.astype(jnp.int32), data.mg_cam, data.n_ext
            )
        )
        ext_active = counts >= thresh
        problem2 = make_ba_problem(data, *lvl, huber_on=True, ext_active=ext_active)
        opt_it2 = 4 if b_large else 10
        new_state, stats = lm_optimize(
            problem2, new_state, opt_it2, lambda_init=lambda_init
        )

    return _lba_finalize(data, state, new_state, err_initial,
                         jnp.asarray(bool(b_large)))


def _lba_finalize(data: LocalBAData, state: BAState, new_state: BAState,
                  err_initial, force_ok) -> LocalBAResult:
    """Shared LocalGPBA epilogue: final chi2 + divergence guard + outlier
    detection at the final state (Optimizer.cc:1259-1338). `force_ok` skips
    the divergence guard (bLarge, Optimizer.cc:1246-1250)."""
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True
    )
    err_final = problem.chi2(new_state)
    ok = force_ok | ~(
        (2.0 * err_initial < err_final)
        | jnp.isnan(err_initial) | jnp.isnan(err_final)
    )

    r_m, _, _, _, _, Xc_m = _mono_gp_eval(data, new_state)
    chi_m = jnp.sum(r_m * r_m, -1) * data.mg_w
    erase_m = data.mg_valid & (
        ((chi_m > CHI2_MONO) & ~data.mg_close)
        | ((chi_m > 1.5 * CHI2_MONO) & data.mg_close)
        | (Xc_m[:, 2] <= 0)
    )
    r_sg, _, _, _, _ = _stereo_gp_eval(data, new_state)
    chi_sg = jnp.sum(r_sg * r_sg, -1) * data.sg_w
    erase_sg = data.sg_valid & (chi_sg > CHI2_STEREO)
    r_st, _, _, z_st = _stereo_eval(data, new_state)
    chi_st = jnp.sum(r_st * r_st, -1) * data.st_w
    erase_st = data.st_valid & jnp.where(
        data.st_is_stereo,
        chi_st > CHI2_STEREO,
        ((chi_st > CHI2_MONO) & ~data.st_close)
        | ((chi_st > 1.5 * CHI2_MONO) & data.st_close)
        | (z_st <= 0),
    )

    # divergence guard: keep original state on failure
    out_state = jax.tree.map(
        lambda a, b: jnp.where(ok, b, a), state, new_state
    )
    return LocalBAResult(
        state=out_state,
        ok=ok,
        err_initial=err_initial,
        err_final=err_final,
        erase_m=erase_m,
        erase_sg=erase_sg,
        erase_st=erase_st,
    )


def global_ba(data: LocalBAData, state: BAState, num_iterations: int = 10):
    """Full-map bundle adjustment (`Optimizer::GlobalBundleAdjustemnt` [sic]
    -> BundleAdjustment, Optimizer.cc:53-367): same edge types as LocalGPBA
    but over every keyframe with only the first fixed, the GP chain robustified
    with Huber delta=21.026 (set data.gp_huber=True), landmarks marginalized,
    lambda_0 = 1e-5 (Optimizer.cc:76). Typically invoked from loop closing
    (`RunGlobalBundleAdjustment`, LoopClosing.cc:1206-1221) with 10 iterations.

    Returns (state', LMStats). Unlike LocalGPBA there is no divergence guard:
    results are staged by the caller (mTbwGBA semantics live in the pipeline).
    """
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True
    )
    return lm_optimize(problem, state, num_iterations, lambda_init=1e-5)


# ----------------------------------------------------------------------
# Interruptible drivers: host-segmented LM with between-segment abort
# checks. This is the device-side counterpart of g2o's setForceStopFlag —
# the reference passes &mbAbortBA into LocalGPBA (Optimizer.cc:79-80 /
# LocalMapping.cc:131) and &mbStopGBA into the detached global BA
# (Optimizer.cc:1254-1255 via LoopClosing.cc:1222), checked once per LM
# iteration. A jitted lax.while_loop cannot poll a host flag, so the
# schedule is cut into segments of `seg_iters` outer iterations; the full
# LM carry (solver/lm.py LMCarry) is checkpointed between segments, making
# the un-aborted segmented run BIT-IDENTICAL to the monolithic one (pinned
# by tests/test_abort_ba.py).


@jax.jit
def _ilm_init(data: LocalBAData, state: BAState) -> LMCarry:
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True
    )
    return lm_init(problem, state)


@jax.jit
def _ilm_seg(data: LocalBAData, carry: LMCarry, it_end, lambda_init) -> LMCarry:
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True
    )
    return lm_segment(problem, carry, it_end, lambda_init=lambda_init)


@jax.jit
def _ilm_init_ext(data: LocalBAData, state: BAState, ext_active) -> LMCarry:
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True,
        ext_active=ext_active,
    )
    return lm_init(problem, state)


@jax.jit
def _ilm_seg_ext(data: LocalBAData, carry: LMCarry, ext_active, it_end,
                 lambda_init) -> LMCarry:
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True,
        ext_active=ext_active,
    )
    return lm_segment(problem, carry, it_end, lambda_init=lambda_init)


_lba_finalize_jit = jax.jit(_lba_finalize)


def _run_segments(seg_fn, carry: LMCarry, total_iters: int, seg_iters: int,
                  should_abort) -> tuple[LMCarry, bool]:
    """Drive `seg_fn(carry, it_end)` to `total_iters` in `seg_iters` chunks,
    polling `should_abort()` between chunks (host-blocking on each boundary;
    the final chunk is left async for the caller). Returns (carry, aborted).
    """
    it = 0
    aborted = False
    while it < total_iters:
        it = min(it + max(1, seg_iters), total_iters)
        carry = seg_fn(carry, jnp.asarray(it, jnp.int32))
        if it >= total_iters:
            break
        if bool(jax.device_get(carry.term)):  # blocks until segment done
            break
        if should_abort is not None and should_abort():
            aborted = True
            break
    return carry, aborted


def local_gp_ba_interruptible(
    data: LocalBAData,
    state: BAState,
    b_large: bool = False,
    b_extrinsic: bool = False,
    ext_obs_count=None,
    ext_min_obs: int = 50,
    should_abort=None,
    seg_iters: int = 4,
):
    """local_gp_ba with the reference's mbAbortBA force-stop semantics
    (LocalMapping.cc:131/215: a new keyframe arriving interrupts the running
    LocalGPBA; g2o stops at the next iteration boundary and the partial
    iterate is still recovered/written back). Returns (LocalBAResult,
    aborted). Bit-identical to local_gp_ba when no abort fires; an abort
    skips the remaining schedule (incl. the whole extrinsic phase, matching
    bDoMore=false at LocalMapping.cc:148)."""
    lambda_init = jnp.asarray(1e-2 if b_large else 1.0)
    carry = _ilm_init(data, state)
    carry, aborted = _run_segments(
        lambda c, e: _ilm_seg(data, c, e, lambda_init),
        carry, 10, seg_iters, should_abort,
    )
    new_state = carry.state

    if b_extrinsic and not aborted:
        counts = (
            ext_obs_count
            if ext_obs_count is not None
            else jax.ops.segment_sum(
                data.mg_valid.astype(jnp.int32), data.mg_cam, data.n_ext
            )
        )
        ext_active = counts >= ext_min_obs
        carry2 = _ilm_init_ext(data, new_state, ext_active)
        opt_it2 = 4 if b_large else 10
        carry2, aborted = _run_segments(
            lambda c, e: _ilm_seg_ext(data, c, ext_active, e, lambda_init),
            carry2, opt_it2, seg_iters, should_abort,
        )
        new_state = carry2.state

    return (
        _lba_finalize_jit(data, state, new_state, carry.chi0,
                          jnp.asarray(bool(b_large))),
        aborted,
    )


def global_ba_interruptible(
    data: LocalBAData,
    state: BAState,
    num_iterations: int = 10,
    should_abort=None,
    seg_iters: int = 2,
):
    """global_ba with the detached-GBA stop flag (mbStopGBA,
    LoopClosing.cc:811-835 / Optimizer.cc:1254-1255): polls `should_abort`
    between LM segments so a newer loop closure can kill a running global
    BA. Returns (state, LMStats, aborted); an aborted run's result must be
    DISCARDED by the caller (RunGlobalBundleAdjustment only writes back
    `if(!mbStopGBA)`, LoopClosing.cc:1249)."""
    carry = _ilm_init(data, state)
    carry, aborted = _run_segments(
        lambda c, e: _ilm_seg(data, c, e, jnp.asarray(1e-5)),
        carry, num_iterations, seg_iters, should_abort,
    )
    stats = LMStats(chi2=carry.chi, iterations=carry.it, lam=carry.lam,
                    initial_chi2=carry.chi0)
    return carry.state, stats, aborted


def make_structure_ids(pairs: "np.ndarray", cams: "np.ndarray | None", valid,
                       n_poses: int, n_ext: int, pad_to: "int | None" = None):
    """Host-side: compact structure ids + per-structure column tables for
    LocalBAData.mg_sid/mg_sid_cols (and sg_*, with cams=None).

    Returns (sid (E,), sid_cols (S, 24 or 30)). Padded/invalid edges map to a
    zero-filled dump structure (their Jacobians are masked to zero anyway).
    `pad_to` pads S (zero-filled rows = more dump structures, pointing at
    pose 0 — finite and unused); callers pass a high-water bucket so the
    structure count does not retrace the solver every window.
    """
    import numpy as _np

    pairs = _np.asarray(pairs, _np.int64)
    E = pairs.shape[0]
    valid = _np.asarray(valid, bool)
    width = 30 if cams is not None else 24
    if E == 0:
        return (_np.zeros(0, _np.int32),
                _np.zeros((pad_to or 1, width), _np.int32))
    # cam may equal n_ext (the virtual stereo row for stereo-camera GPObs
    # mono edges), so the key space has n_ext + 1 camera slots
    n_slots = n_ext + 1
    if cams is not None:
        key = (pairs[:, 0] * n_poses + pairs[:, 1]) * n_slots + _np.asarray(cams, _np.int64)
    else:
        key = pairs[:, 0] * n_poses + pairs[:, 1]
    key = _np.where(valid, key, -1)
    uniq, inv = _np.unique(key, return_inverse=True)
    has_dump = uniq[0] == -1
    if not has_dump:
        uniq = _np.concatenate([[-1], uniq])
        inv = inv + 1
    S = len(uniq)
    S_pad = max(pad_to or 0, S)
    cols = _np.zeros((S_pad, width), _np.int32)
    for s_i in range(1, S):
        k = uniq[s_i]
        if cams is not None:
            c = k % n_slots
            ij = k // n_slots
        else:
            ij = k
        i, j = ij // n_poses, ij % n_poses
        base = _np.concatenate([12 * i + _np.arange(12), 12 * j + _np.arange(12)])
        if cams is not None:
            # extrinsic vertices live in 12-wide phantom column groups
            # (cols 6..11 inactive) so the landmark coupling Wt assembles
            # from uniform (3,12) blocks without a column remap.
            # c == n_ext (virtual stereo row) has no extrinsic columns; its
            # Jext blocks are zeroed, so clamp into bounds — the zeros land
            # harmlessly in the last real extrinsic group.
            c = min(c, max(n_ext - 1, 0))
            base = _np.concatenate([base, 12 * n_poses + 12 * c + _np.arange(6)])
        cols[s_i] = base
    # dump structure (index 0) carries zero blocks; its columns are 0..w-1
    # but contribute nothing (zero values)
    #
    # Enforce the add_seg 12-aligned-group invariant the unified Hpp
    # assembly relies on (ba.py `units = cols_all[:, ::12] // 12`): group
    # starts 12-aligned, columns contiguous within each 12-group. Padded
    # zero rows satisfy it trivially. Host-side and O(S) — cheap relative
    # to problem extraction; fails loudly instead of corrupting Hpp.
    starts = cols[:, ::12]
    if (starts % 12).any():
        raise AssertionError("make_structure_ids: group start not 12-aligned")
    for g0 in range(0, width, 12):
        gw = min(12, width - g0)
        grp = cols[:, g0:g0 + gw]
        if (grp != grp[:, :1] + _np.arange(gw)[None, :]).any():
            # the 6-wide extrinsic tail group only fills offsets 0..5; the
            # remaining padded zeros are exempt (zero-valued blocks)
            nz = grp != 0
            bad = nz & (grp != grp[:, :1] + _np.arange(gw)[None, :])
            if bad.any():
                raise AssertionError(
                    "make_structure_ids: non-contiguous columns in group"
                )
    return inv.astype(_np.int32), cols


def build_interp_tables(sid, t, valid, pad_to: int | None = None):
    """Host-side: unique (structure id, timestamp) combo table for the
    interp-pack fast path (LocalBAData.mg_it/mg_it_sid/mg_it_t and sg_*).

    Async cameras fire at fixed per-camera phases (Frame.cc:200-207), so the
    edges of one window share O(K*C) distinct interpolation timestamps; the
    whole GP chain is evaluated once per combo and gathered per edge.
    Invalid/padded edges map to combo 0, whose pack may be non-finite (dump
    structure has i==j) — consumers must where-mask those edges' outputs,
    which linearize/chi2 already do.

    Returns (it (E,) int32, it_sid (U,) int32, it_t (U,) float64) with U
    padded to `pad_to` (>= observed U) when given, else to the next pow2.
    """
    import numpy as _np

    sid = _np.asarray(sid, _np.int64)
    t = _np.asarray(t, _np.float64)
    valid = _np.asarray(valid, bool)
    E = sid.shape[0]
    if E == 0:
        U = pad_to or 1
        return (_np.zeros(0, _np.int32), _np.zeros(U, _np.int32),
                _np.zeros(U, _np.float64))
    # key on (sid, exact time bits); invalid edges -> dump combo 0
    key_t = t.view(_np.int64)
    v_sid = _np.where(valid, sid, -1)
    rows = _np.stack([v_sid, _np.where(valid, key_t, 0)], axis=1)
    uniq, inv = _np.unique(rows, axis=0, return_inverse=True)
    has_dump = uniq[0, 0] == -1
    if not has_dump:
        uniq = _np.concatenate([_np.array([[-1, 0]], _np.int64), uniq])
        inv = inv + 1
    U_real = len(uniq)
    U = pad_to if pad_to is not None else _bucket_pow2(U_real)
    if U < U_real:
        raise ValueError(f"pad_to={pad_to} < observed combos {U_real}")
    it_sid = _np.zeros(U, _np.int32)
    it_t = _np.zeros(U, _np.float64)
    it_sid[1:U_real] = uniq[1:, 0].astype(_np.int32)
    it_t[1:U_real] = _np.ascontiguousarray(uniq[1:, 1]).view(_np.float64)
    return inv.astype(_np.int32), it_sid, it_t


def _bucket_pow2(n: int, minimum: int = 4) -> int:
    from ..utils.shapes import bucket_pow2

    return bucket_pow2(n, minimum)


def make_landmark_tables(mg_lm, mg_pair, mg_cam, mg_valid,
                         sg_lm, sg_pair, sg_valid,
                         st_lm, st_pose, st_valid,
                         n_lm: int, n_poses: int, n_ext: int,
                         pad_d: "int | None" = None,
                         pad_de: "int | None" = None):
    """Host-side landmark-major gather tables for scatter-free Wt/Hll/bl
    assembly (gathers + one batched matmul replace the scatter-adds).

    Block array layout (must match linearize): the per-edge landmark-coupling
    (3,12) blocks concatenate as [mono-i | mono-j | mono-ext | sg-i | sg-j |
    st]; the per-edge landmark-system rows as [mono | sg | st].

    Returns (lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid) numpy
    arrays, slot counts bucketed to powers of two.
    """
    import numpy as _np

    mg_lm = _np.asarray(mg_lm, _np.int64)
    sg_lm = _np.asarray(sg_lm, _np.int64)
    st_lm = _np.asarray(st_lm, _np.int64)
    mg_valid = _np.asarray(mg_valid, bool)
    sg_valid = _np.asarray(sg_valid, bool)
    st_valid = _np.asarray(st_valid, bool)
    mg_pair = _np.asarray(mg_pair, _np.int64).reshape(-1, 2)
    sg_pair = _np.asarray(sg_pair, _np.int64).reshape(-1, 2)
    mg_cam = _np.asarray(mg_cam, _np.int64)
    st_pose = _np.asarray(st_pose, _np.int64)
    Em, Eg, Es = len(mg_lm), len(sg_lm), len(st_lm)

    # (landmark, block index, column group) for every valid block
    lm_parts, idx_parts, g_parts = [], [], []

    def add(lm, valid, idx, g):
        lm_parts.append(lm[valid])
        idx_parts.append(idx[valid])
        g_parts.append(g[valid])

    base = _np.arange(Em, dtype=_np.int64)
    add(mg_lm, mg_valid, base, mg_pair[:, 0])
    add(mg_lm, mg_valid, base + Em, mg_pair[:, 1])
    # clamp the virtual stereo row (cam == n_ext) into the last real
    # extrinsic group: its coupling blocks are zero, placement is moot
    add(mg_lm, mg_valid, base + 2 * Em,
        n_poses + _np.minimum(mg_cam, max(n_ext - 1, 0)))
    baseg = _np.arange(Eg, dtype=_np.int64)
    add(sg_lm, sg_valid, baseg + 3 * Em, sg_pair[:, 0])
    add(sg_lm, sg_valid, baseg + 3 * Em + Eg, sg_pair[:, 1])
    add(st_lm, st_valid, _np.arange(Es, dtype=_np.int64) + 3 * Em + 2 * Eg,
        st_pose)

    def pack(lms, vals, extra=None, pad=None):
        """Group (lms -> vals) into a padded (L, D) table. `pad` (from a
        caller-side high-water bucket) keeps D monotonic across windows so
        the observation-count maximum doesn't retrace the solver."""
        order = _np.argsort(lms, kind="stable")
        s_lm = lms[order]
        s_val = vals[order]
        starts = _np.searchsorted(s_lm, _np.arange(n_lm))
        counts = _np.diff(_np.append(starts, len(s_lm)))
        D = _bucket_pow2(int(counts.max()) if len(counts) else 1)
        D = max(D, pad or 0)
        pos = _np.arange(len(s_lm)) - starts[s_lm]
        tab = _np.zeros((n_lm, D), _np.int32)
        val = _np.zeros((n_lm, D), bool)
        tab[s_lm, pos] = s_val.astype(_np.int32)
        val[s_lm, pos] = True
        ext = None
        if extra is not None:
            s_ext = extra[order]
            ext = _np.zeros((n_lm, D), _np.int32)
            ext[s_lm, pos] = s_ext.astype(_np.int32)
        return tab, val, ext

    lm_all = _np.concatenate(lm_parts) if lm_parts else _np.zeros(0, _np.int64)
    idx_all = _np.concatenate(idx_parts) if idx_parts else _np.zeros(0, _np.int64)
    g_all = _np.concatenate(g_parts) if g_parts else _np.zeros(0, _np.int64)
    lm_blk, lm_blk_valid, lm_blk_g = pack(lm_all, idx_all, g_all, pad=pad_d)

    e_lm = _np.concatenate([mg_lm[mg_valid], sg_lm[sg_valid], st_lm[st_valid]])
    e_idx = _np.concatenate(
        [base[mg_valid], baseg[sg_valid] + Em,
         _np.arange(Es, dtype=_np.int64)[st_valid] + Em + Eg]
    )
    lm_edge, lm_edge_valid, _ = pack(e_lm, e_idx, pad=pad_de)
    return lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid


def with_landmark_tables(data: LocalBAData, n_lm: int,
                         pad_d: "int | None" = None,
                         pad_de: "int | None" = None) -> LocalBAData:
    """Host-side: attach the landmark-major gather tables to a concrete
    LocalBAData instance (fast scatter-free assembly path)."""
    lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid = make_landmark_tables(
        data.mg_lm, data.mg_pair, data.mg_cam, data.mg_valid,
        data.sg_lm, data.sg_pair, data.sg_valid,
        data.st_lm, data.st_pose, data.st_valid,
        n_lm, data.n_poses, data.n_ext,
        pad_d=pad_d, pad_de=pad_de,
    )
    return data._replace(
        lm_blk=jnp.asarray(lm_blk),
        lm_blk_g=jnp.asarray(lm_blk_g),
        lm_blk_valid=jnp.asarray(lm_blk_valid),
        lm_edge=jnp.asarray(lm_edge),
        lm_edge_valid=jnp.asarray(lm_edge_valid),
    )
