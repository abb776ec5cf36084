"""Multi-chip local BA: landmark-axis sharding over a device mesh.

The reference is single-process shared-memory (SURVEY.md §2.13); the
device scaling axis for bundle adjustment is the landmark/observation
dimension of the Schur complement. Decomposition:

  * pose-vel states, extrinsics, and the dense reduced system: REPLICATED
  * landmarks, their observations (edges), Hll, bl, W coupling blocks:
    SHARDED over mesh axis "l"

Each device linearizes its own edge shard (reusing the single-chip
`make_ba_problem` closures on the local block), then:

  Hpp, bp           -> psum over "l"  (pose-level edges live on shard 0)
  Hschur correction  = psum_l( W_l Hll_l^-1 W_l^T )   — one all-reduce of a
                       (P,P) matrix, P = 12K + 6C (tiny vs the per-shard
                       contraction it replaces)
  reduced solve      -> replicated dense Cholesky
  dx_landmarks       -> local back-substitution, no communication

This gives strong scaling in #landmarks with one (P,P)+(P,) all-reduce per
trial (NCCL over NVLink on GPUs). Host-side `shard_ba_data` reorders/pads the SoA edge
arrays into contiguous equal shard blocks with shard-local landmark ids.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solver.ba import BAState, LocalBAData, make_ba_problem
from ..solver.lm import LMProblem


class ShardedBA(NamedTuple):
    data: LocalBAData      # edge/landmark arrays have leading blocks per shard
    state0: BAState        # X reordered into shard blocks
    lm_perm: np.ndarray    # original-id -> sharded-position permutation
    n_shards: int
    lm_per_shard: int


def _pad_to(arr, n, fill=0):
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr[:n]
    width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width, constant_values=fill)


def shard_ba_data(data: LocalBAData, state: BAState, n_shards: int) -> ShardedBA:
    """Host-side resharding of a LocalBAData instance for an "l" mesh axis."""
    L = state.X.shape[0]
    lm_per = -(-L // n_shards)
    L_pad = lm_per * n_shards

    # Round-robin assignment: landmark `orig` lives on shard `orig % n` at
    # local slot `orig // n` — balances observation counts across shards.
    def shard_edges(lm_ids, arrays, valid):
        """Partition edge arrays by landmark shard; pad each block equally.
        Returns (arrays', valid', lm_local')."""
        lm_ids = np.asarray(lm_ids)
        valid = np.asarray(valid)
        shard = lm_ids % n_shards if len(lm_ids) else np.zeros(0, np.int64)
        local = lm_ids // n_shards if len(lm_ids) else np.zeros(0, np.int64)
        counts = np.bincount(shard, minlength=n_shards) if len(lm_ids) else np.zeros(n_shards, int)
        per = int(counts.max()) if counts.size else 1
        per = max(per, 1)
        outs = []
        for a in arrays:
            a = np.asarray(a)
            blocks = []
            for s in range(n_shards):
                m = shard == s
                blocks.append(_pad_to(a[m], per))
            outs.append(np.concatenate(blocks, 0))
        vblocks, lblocks = [], []
        for s in range(n_shards):
            m = shard == s
            vblocks.append(_pad_to(valid[m], per, fill=False))
            lblocks.append(_pad_to(local[m], per))
        return outs, np.concatenate(vblocks), np.concatenate(lblocks)

    has_it = data.mg_it is not None
    zero_mg_it = np.zeros(len(np.asarray(data.mg_lm)), np.int32)
    zero_sg_it = np.zeros(len(np.asarray(data.sg_lm)), np.int32)
    (mg_arrs, mg_valid, mg_lm) = shard_edges(
        data.mg_lm,
        [data.mg_pair, data.mg_cam, data.mg_t, data.mg_obs, data.mg_w,
         data.mg_close, data.mg_sid,
         data.mg_it if has_it else zero_mg_it],
        data.mg_valid,
    )
    (sg_arrs, sg_valid, sg_lm) = shard_edges(
        data.sg_lm,
        [data.sg_pair, data.sg_t, data.sg_obs, data.sg_w, data.sg_sid,
         data.sg_it if data.sg_it is not None else zero_sg_it],
        data.sg_valid,
    )
    (st_arrs, st_valid, st_lm) = shard_edges(
        data.st_lm,
        [data.st_pose, data.st_obs, data.st_w, data.st_is_stereo, data.st_close],
        data.st_valid,
    )

    # X reordering: sharded array position (s * lm_per + i) holds original
    # landmark (i * n_shards + s); perm_pos maps sharded position -> original
    # id (-1 for padding), so callers can unshard results.
    X = np.asarray(state.X)
    Xs = np.zeros((L_pad, 3), X.dtype)
    perm_pos = np.full(L_pad, -1, np.int64)
    orig_ids = np.arange(L)
    dst = (orig_ids % n_shards) * lm_per + orig_ids // n_shards
    Xs[dst] = X
    perm_pos[dst] = orig_ids

    dtype = np.asarray(data.mg_obs).dtype

    data_s = data._replace(
        mg_pair=jnp.asarray(mg_arrs[0], jnp.int32),
        mg_cam=jnp.asarray(mg_arrs[1], jnp.int32),
        mg_t=jnp.asarray(mg_arrs[2], dtype),
        mg_obs=jnp.asarray(mg_arrs[3], dtype),
        mg_w=jnp.asarray(mg_arrs[4], dtype),
        mg_close=jnp.asarray(mg_arrs[5]),
        mg_sid=jnp.asarray(mg_arrs[6], jnp.int32),
        mg_valid=jnp.asarray(mg_valid),
        mg_lm=jnp.asarray(mg_lm, jnp.int32),
        sg_pair=jnp.asarray(sg_arrs[0], jnp.int32),
        sg_t=jnp.asarray(sg_arrs[1], dtype),
        sg_obs=jnp.asarray(sg_arrs[2], dtype),
        sg_w=jnp.asarray(sg_arrs[3], dtype),
        sg_sid=jnp.asarray(sg_arrs[4], jnp.int32),
        sg_valid=jnp.asarray(sg_valid),
        sg_lm=jnp.asarray(sg_lm, jnp.int32),
        st_pose=jnp.asarray(st_arrs[0], jnp.int32),
        st_obs=jnp.asarray(st_arrs[1], dtype),
        st_w=jnp.asarray(st_arrs[2], dtype),
        st_is_stereo=jnp.asarray(st_arrs[3]),
        st_close=jnp.asarray(st_arrs[4]),
        st_valid=jnp.asarray(st_valid),
        st_lm=jnp.asarray(st_lm, jnp.int32),
        # interp-combo tables: per-edge index shards with the edges, the
        # (small) combo tables replicate; padded edge rows point at the
        # dump combo 0, whose outputs the masks kill.
        mg_it=jnp.asarray(mg_arrs[7], jnp.int32) if has_it else None,
        mg_it_sid=data.mg_it_sid if has_it else None,
        mg_it_t=data.mg_it_t if has_it else None,
        sg_it=(jnp.asarray(sg_arrs[5], jnp.int32)
               if data.sg_it is not None else None),
        sg_it_sid=data.sg_it_sid,
        sg_it_t=data.sg_it_t,
    )
    # Per-shard landmark gather tables: each shard's edge arrays are equal
    # contiguous blocks with LOCAL landmark ids, so tables must be rebuilt
    # per shard on the local slices (the global tables index the unsharded
    # layout). Slot widths are padded to the max across shards so the
    # stacked tables shard along the landmark axis with one static shape.
    from ..solver.ba import make_landmark_tables

    def blocks(a):
        a = np.asarray(a)
        return a.reshape(n_shards, a.shape[0] // n_shards, *a.shape[1:])

    per_shard = []
    for s in range(n_shards):
        per_shard.append(
            make_landmark_tables(
                blocks(data_s.mg_lm)[s], blocks(data_s.mg_pair)[s],
                blocks(data_s.mg_cam)[s], blocks(data_s.mg_valid)[s],
                blocks(data_s.sg_lm)[s], blocks(data_s.sg_pair)[s],
                blocks(data_s.sg_valid)[s],
                blocks(data_s.st_lm)[s], blocks(data_s.st_pose)[s],
                blocks(data_s.st_valid)[s],
                lm_per, data.n_poses, data.n_ext,
            )
        )
    D = max(t[0].shape[1] for t in per_shard)
    De = max(t[3].shape[1] for t in per_shard)

    def padw(a, w):
        return np.pad(a, ((0, 0), (0, w - a.shape[1])))

    tab = [
        np.concatenate([padw(t[i], D if i < 3 else De) for t in per_shard])
        for i in range(5)
    ]
    data_s = data_s._replace(
        lm_blk=jnp.asarray(tab[0]),
        lm_blk_g=jnp.asarray(tab[1]),
        lm_blk_valid=jnp.asarray(tab[2].astype(bool)),
        lm_edge=jnp.asarray(tab[3]),
        lm_edge_valid=jnp.asarray(tab[4].astype(bool)),
    )
    state_s = state._replace(X=jnp.asarray(Xs))
    return ShardedBA(data_s, state_s, perm_pos, n_shards, lm_per)


def _shard_fields(n_shards):
    """Which LocalBAData fields are sharded along their leading axis."""
    return {
        "mg_pair", "mg_lm", "mg_cam", "mg_t", "mg_obs", "mg_w", "mg_valid",
        "mg_close", "mg_sid", "mg_it",
        "sg_pair", "sg_lm", "sg_t", "sg_obs", "sg_w", "sg_valid", "sg_sid",
        "sg_it",
        "st_pose", "st_lm", "st_obs", "st_w", "st_valid", "st_is_stereo",
        "st_close",
        "lm_blk", "lm_blk_g", "lm_blk_valid", "lm_edge", "lm_edge_valid",
    }


def make_sharded_ba_problem(mesh: Mesh, sb: ShardedBA, huber_on=True) -> LMProblem:
    """LMProblem whose closures run SPMD over the mesh axis "l".

    Inside the shard_map body each device sees its local edge/landmark block
    as a plain LocalBAData and reuses the single-chip closures; pose-level
    quantities are combined with psum over "l". Pose-level edges (GP chain,
    velocity, extrinsic priors) are computed on every shard and divided by
    the shard count so their psum contributes once.
    """
    data = sb.data
    n = sb.n_shards
    axis = "l"
    shard_set = _shard_fields(n)

    data_specs = LocalBAData(
        **{
            f: (None if getattr(data, f) is None
                else (P(axis) if f in shard_set else P()))
            for f in LocalBAData._fields
        }
    )
    state_specs = BAState(T=P(), v=P(), Text=P(), X=P(axis))
    dx_specs = (P(), P(axis))

    inv_n = 1.0 / n

    def local_problem(data_local):
        return make_ba_problem(
            data_local,
            data_local.mg_valid,
            data_local.sg_valid,
            data_local.st_valid,
            huber_on=huber_on,
        )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(data_specs, state_specs),
        out_specs=P(),
    )
    def chi2_sm(data_local, state_local):
        p = local_problem(data_local)
        c_all = p.chi2(state_local)
        # split edge-level (sharded) from pose-level (replicated) chi2: the
        # pose-level part is recomputed identically on each shard; weight it
        # by 1/n so the psum counts it once.
        zero_edges = data_local._replace(
            mg_valid=jnp.zeros_like(data_local.mg_valid),
            sg_valid=jnp.zeros_like(data_local.sg_valid),
            st_valid=jnp.zeros_like(data_local.st_valid),
        )
        c_pose = local_problem(zero_edges).chi2(state_local)
        c = (c_all - c_pose) + inv_n * c_pose
        return jax.lax.psum(c, axis)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(data_specs, state_specs),
        out_specs=(P(), P(), P(axis), P(axis), P(axis)),
    )
    def linearize_sm(data_local, state_local):
        p = local_problem(data_local)
        Hpp, bp, Wt, Hll, bl = p.linearize(state_local)
        zero_edges = data_local._replace(
            mg_valid=jnp.zeros_like(data_local.mg_valid),
            sg_valid=jnp.zeros_like(data_local.sg_valid),
            st_valid=jnp.zeros_like(data_local.st_valid),
        )
        Hpp0, bp0, _, _, _ = local_problem(zero_edges).linearize(state_local)
        Hpp = (Hpp - Hpp0) + inv_n * Hpp0
        bp = (bp - bp0) + inv_n * bp0
        Hpp = jax.lax.psum(Hpp, axis)
        bp = jax.lax.psum(bp, axis)
        return Hpp, bp, Wt, Hll, bl

    K = data.n_poses
    Cx = data.n_ext
    dtype = data.mg_obs.dtype
    pose_act = (~data.pose_fixed).astype(dtype)
    ext_act = (~data.ext_fixed).astype(dtype)
    # 12-wide phantom extrinsic column groups (see make_ba_problem)
    phantom = jnp.tile(
        jnp.concatenate([jnp.ones(6, dtype), jnp.zeros(6, dtype)]), Cx
    )
    act_vec = jnp.concatenate(
        [jnp.repeat(pose_act, 12), jnp.repeat(ext_act, 12) * phantom]
    )
    n_cols = 12 * (K + Cx)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(), P(), P(axis), P(axis), P(axis)), P()),
        out_specs=((P(), P(axis)), P(), P()),
    )
    def solve_sm(lin, lam):
        Hpp, bp, Wt, Hll, bl = lin
        from ..solver.ba import _inv3x3

        eye3 = jnp.eye(3, dtype=dtype)
        Hll_inv = _inv3x3(Hll + lam * eye3[None])
        Y = jnp.einsum("lab,lbp->lap", Hll_inv, Wt)
        corr = jax.lax.psum(jnp.einsum("lap,laq->pq", Y, Wt), axis)
        bcorr = jax.lax.psum(jnp.einsum("lap,la->p", Y, bl), axis)
        Hs = (
            Hpp
            + jnp.eye(n_cols, dtype=dtype)
            * (lam * act_vec + (1.0 - act_vec))[None, :]
            - corr
        )
        bs = bp - bcorr
        Lc, lower = jax.scipy.linalg.cho_factor(Hs)
        dxp = jax.scipy.linalg.cho_solve((Lc, lower), bs)
        dxl = jnp.einsum(
            "lab,lb->la", Hll_inv, bl - jnp.einsum("lap,p->la", Wt, dxp)
        )
        dot_xx = dxp @ dxp + jax.lax.psum(jnp.sum(dxl * dxl), axis)
        dot_xb = dxp @ bp + jax.lax.psum(jnp.sum(dxl * bl), axis)
        return (dxp, dxl), dot_xx, dot_xb

    def chi2(state):
        return chi2_sm(data, state)

    def linearize(state):
        return linearize_sm(data, state)

    def max_abs_diag(lin):
        Hpp, bp, Wt, Hll, bl = lin
        m1 = jnp.max(jnp.abs(jnp.diagonal(Hpp)) * act_vec)
        m2 = jnp.max(jnp.abs(Hll[..., jnp.arange(3), jnp.arange(3)]))
        return jnp.maximum(m1, m2)

    def solve(lin, lam):
        return solve_sm(lin, lam)

    from ..ops import lie

    def retract(state, dx):
        dxp, dxl = dx
        dpose = dxp[: 12 * K].reshape(K, 12)
        dext = dxp[12 * K:].reshape(Cx, 12)[:, :6]
        T = jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.T, dpose[:, :6])
        Text = jax.vmap(lambda Ti, di: Ti @ lie.exp_se3(di))(state.Text, dext)
        return BAState(T=T, v=state.v + dpose[:, 6:], Text=Text, X=state.X + dxl)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)
