"""Multi-chip essential-graph optimization: edge-axis sharding over a mesh.

The at-scale pose-graph backend (`make_essential_graph_problem_pcg`,
rebuilding LinearSolverEigen's sparse Cholesky role at Optimizer.cc:1442-1444
as a matrix-free PCG) is memory- and FLOP-dominated by per-edge work: the
(E,7,14) Jacobians and the two einsum+segment-sum passes of every H·x
product. Those are embarrassingly parallel over edges, so the multi-chip
decomposition is:

  * Sim3 vertex field (N,7), block-Jacobi preconditioner blocks, PCG
    scalars: REPLICATED — (N,7) is tiny (a 10k-KF graph is 280 KB)
  * edges (pairs, measurements, residuals, Jacobians): SHARDED over "e"

Per CG iteration each device computes its local J_e^T(J_e x) contribution
and one psum of an (N,7) vector crosses the interconnect — ~280 KB at 10k KFs, far below
the per-device matvec it amortizes. The LM trial loop and PCG while_loop run
replicated (identical scalars on every device), so control flow needs no
host round-trips.

Host-side `shard_eg_data` pads the edge arrays into equal contiguous blocks
(padding rows are valid=False and contribute exact zeros).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import sim3
from ..ops.sim3 import Sim3
from ..solver.lm import LMProblem
from ..solver.sim3_opt import (
    EssentialGraphData,
    Sim3Field,
    _eg_residual_jacs,
    _eg_residuals,
)


class ShardedEG(NamedTuple):
    data: EssentialGraphData  # edge arrays padded to n_shards * e_per_shard
    n_shards: int
    e_per_shard: int


def shard_eg_data(data: EssentialGraphData, n_shards: int) -> ShardedEG:
    """Pad the edge axis to a multiple of n_shards (block-contiguous)."""
    E = int(np.asarray(data.pairs).shape[0])
    per = max(-(-E // n_shards), 1)
    E_pad = per * n_shards

    def pad(a, fill=0):
        a = np.asarray(a)
        if a.shape[0] >= E_pad:
            return a[:E_pad]
        width = [(0, E_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    eyeR = np.tile(np.eye(3, dtype=np.asarray(data.meas_R).dtype),
                   (E_pad, 1, 1))
    meas_R = np.asarray(data.meas_R)
    meas_R = np.concatenate([meas_R, eyeR[len(meas_R):]]) if len(meas_R) < E_pad else meas_R[:E_pad]
    padded = EssentialGraphData(
        pairs=jnp.asarray(pad(data.pairs)),
        meas_s=jnp.asarray(pad(data.meas_s, fill=1)),
        meas_R=jnp.asarray(meas_R),
        meas_t=jnp.asarray(pad(data.meas_t)),
        valid=jnp.asarray(pad(data.valid, fill=False)),
        fixed=data.fixed,
        fix_scale=data.fix_scale,
    )
    return ShardedEG(padded, n_shards, per)


def make_sharded_eg_problem(
    mesh: Mesh, se: ShardedEG, pcg_iters: int = 250, pcg_tol: float = 1e-10
) -> LMProblem:
    """LMProblem running SPMD over mesh axis "e" with edge-sharded PCG.

    Parity contract: identical arithmetic to the single-device PCG problem
    up to psum summation order (sharded segment-sums accumulate per shard
    then all-reduce; tested at 1e-10 on the f64 CPU mesh).
    """
    data = se.data
    axis = "e"

    edge_specs = EssentialGraphData(
        pairs=P(axis), meas_s=P(axis), meas_R=P(axis), meas_t=P(axis),
        valid=P(axis), fixed=P(), fix_scale=P(),
    )
    state_specs = Sim3Field(s=P(), R=P(), t=P())
    lin_specs = (P(axis), P(axis), P(axis), P(axis), P(), P(), P())

    @partial(jax.shard_map, mesh=mesh, in_specs=(edge_specs, state_specs),
             out_specs=P())
    def chi2_sm(d, state):
        r = _eg_residuals(state, d)
        r = jnp.where(d.valid[:, None], r, 0.0)
        return jax.lax.psum(jnp.sum(r * r), axis)

    @partial(jax.shard_map, mesh=mesh, in_specs=(edge_specs, state_specs),
             out_specs=lin_specs)
    def linearize_sm(d, state):
        dtype = state.t.dtype
        r, J = _eg_residual_jacs(state, d)
        i_, j_ = d.pairs[:, 0], d.pairs[:, 1]
        act = (~d.fixed).astype(dtype)
        m = d.valid[:, None]
        r = jnp.where(m, r, 0.0)
        J = jnp.where(m[..., None], J, 0.0)
        Ji = J[:, :, :7] * act[i_][:, None, None]
        Jj = J[:, :, 7:] * act[j_][:, None, None]
        N = state.s.shape[0]
        Di = jax.ops.segment_sum(jnp.einsum("eri,erj->eij", Ji, Ji), i_, N)
        Dj = jax.ops.segment_sum(jnp.einsum("eri,erj->eij", Jj, Jj), j_, N)
        D = jax.lax.psum(Di + Dj, axis)
        bi = jax.ops.segment_sum(-jnp.einsum("eri,er->ei", Ji, r), i_, N)
        bj = jax.ops.segment_sum(-jnp.einsum("eri,er->ei", Jj, r), j_, N)
        b = jax.lax.psum(bi + bj, axis)
        return Ji, Jj, i_, j_, D, b, act

    @partial(jax.shard_map, mesh=mesh, in_specs=(lin_specs, P()),
             out_specs=(P(), P(), P()))
    def solve_sm(lin, lam):
        Ji, Jj, i_, j_, D, b, act = lin
        dtype = b.dtype
        N = b.shape[0]
        eye7 = jnp.eye(7, dtype=dtype)
        Dd = D + (lam * act + (1.0 - act))[:, None, None] * eye7[None]
        Minv = jnp.linalg.inv(Dd)

        def Hx(x):  # x: (N,7) replicated
            u = jnp.einsum("erc,ec->er", Ji, x[i_]) + jnp.einsum(
                "erc,ec->er", Jj, x[j_]
            )
            out = jax.ops.segment_sum(
                jnp.einsum("erc,er->ec", Ji, u), i_, N
            ) + jax.ops.segment_sum(jnp.einsum("erc,er->ec", Jj, u), j_, N)
            out = jax.lax.psum(out, axis)
            return out + (lam * act + (1.0 - act))[:, None] * x

        def dot(a, c):
            return jnp.sum(a * c)

        x0 = jnp.zeros_like(b)
        z0 = jnp.einsum("nij,nj->ni", Minv, b)
        rz0 = dot(b, z0)
        bnorm = jnp.maximum(dot(b, b), jnp.asarray(1e-30, dtype))

        def body(c):
            x, rr, z, p, rz, it = c
            Hp = Hx(p)
            alpha = rz / jnp.maximum(dot(p, Hp), jnp.asarray(1e-30, dtype))
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = jnp.einsum("nij,nj->ni", Minv, rr)
            rz_new = dot(rr, z)
            beta = rz_new / jnp.maximum(rz, jnp.asarray(1e-30, dtype))
            p = z + beta * p
            return x, rr, z, p, rz_new, it + 1

        def cond(c):
            _, rr, _, _, _, it = c
            return (it < pcg_iters) & (dot(rr, rr) > pcg_tol * bnorm)

        x, *_ = jax.lax.while_loop(cond, body, (x0, b, z0, z0, rz0, 0))
        dx = x.reshape(-1)
        return dx, dx @ dx, dx @ b.reshape(-1)

    def chi2(state):
        return chi2_sm(data, state)

    def linearize(state):
        return linearize_sm(data, state)

    def max_abs_diag(lin):
        *_, D, b, act = lin
        diag = jnp.vectorize(jnp.diagonal, signature="(a,a)->(a)")(D)
        return jnp.max(jnp.abs(diag) * act[:, None])

    def solve(lin, lam):
        return solve_sm(lin, lam)

    def retract(state: Sim3Field, dx):
        N = state.s.shape[0]
        d = dx.reshape(N, 7)

        def one(s, R, t, di):
            S = sim3.retract_left(Sim3(s, R, t), di, data.fix_scale)
            return S.s, S.R, S.t

        s, R, t = jax.vmap(one)(state.s, state.R, state.t, d)
        return Sim3Field(s=s, R=R, t=t)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)
