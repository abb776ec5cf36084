"""Device-time share of one named scope inside the jitted local GP-BA LM
iteration (50 KF / 5k points, float32; the bench.py headline shape).

Traces `--iters` chained iterations with jax.profiler, then attributes each
kernel on the device to the HLO instruction that launched it (the trace's
`hlo_op` stat, or the kernel's own name when XLA ran it inside a CUDA graph,
where `hlo_op` is the command buffer) and that instruction to its
`jax.named_scope` path (the compiled HLO's op_name metadata). Prints the
scope's share of the kernel time, its kernel launches per iteration and its
distinct kernels, and writes
`summary.json`, the compiled HLO (`hlo.txt.gz`, for reducing the trace
again offline with `report`) and the raw `.xplane.pb` under `--out`.

Usage: python examples/trace_lm_iteration.py [--out DIR]
The scope is the GP interpolation chain (solver/ba.py _interp_packs).
Needs a GPU: the CPU backend has no device timeline.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from amcslam_tpu.solver.ba import make_ba_problem
from amcslam_tpu.utils.synthetic import make_local_ba_problem

SCOPE = "gp_interp_packs"
ITERS = 10
_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"', re.M)


def _norm(name: str) -> str:
    """Kernel names spell HLO instruction names with '_' for '.' and '-'."""
    return re.sub(r"[.\-]", "_", name)


def op_names(hlo_text: str) -> dict:
    """Normalized HLO instruction name -> op_name metadata (scope path)."""
    return {_norm(k): v for k, v in _INSTR.findall(hlo_text)}


def _stats(event) -> dict:
    out = {}
    for k, v in event.stats:
        out[k] = v
    return out


def reduce_trace(xplane_path: str, ops: dict, scope: str, n_iters: int):
    """Kernel time on the device planes, split into the scope and the rest."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    kernels, lines_seen = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            lines_seen.add(f"{plane.name} | {line.name}")
            # the per-stream lines hold one event per kernel launch; the
            # summary lines ("XLA Ops", "XLA Modules", ...) would double count
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                hlo = _norm(str(_stats(ev).get("hlo_op", "")))
                if hlo not in ops:
                    hlo = _norm(ev.name)
                kernels.append((hlo, ev.name, ev.duration_ns))
    if not kernels:
        raise RuntimeError(f"no device kernels in the trace; lines: "
                           f"{sorted(lines_seen)}")
    total = sum(d for _, _, d in kernels)
    in_scope = [(h, n, d) for h, n, d in kernels if scope in ops.get(h, "")]
    t_scope = sum(d for _, _, d in in_scope)
    return {
        "scope": scope,
        "iters": n_iters,
        "kernel_ms_per_iter": total / n_iters / 1e6,
        "scope_ms_per_iter": t_scope / n_iters / 1e6,
        "scope_share_of_kernel_time": t_scope / max(total, 1),
        "scope_launches_per_iter": len(in_scope) / n_iters,
        "scope_distinct_kernels": len({h for h, _, _ in in_scope}),
        "all_launches_per_iter": len(kernels) / n_iters,
        "unattributed_launches": sum(1 for h, _, _ in kernels if h not in ops),
        "device_lines": sorted(lines_seen),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trace_lm_iteration")
    args = ap.parse_args()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)

    data, state0, _ = make_local_ba_problem(
        n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
        gpobs_per_lm=2, noise_px=0.5, seed=0, dtype=jnp.float32)
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid,
                              data.st_valid)

    def lm_iteration(state, lam):
        lin = problem.linearize(state)
        dx, _, _ = problem.solve(lin, lam)
        new_state = problem.retract(state, dx)
        return new_state, problem.chi2(new_state)

    lam = jnp.asarray(1.0, jnp.float32)
    step = jax.jit(lm_iteration).lower(state0, lam).compile()
    hlo = step.as_text()
    os.makedirs(args.out, exist_ok=True)
    with gzip.open(os.path.join(args.out, "hlo.txt.gz"), "wt") as f:
        f.write(hlo)
    s = state0
    for _ in range(3):
        s, chi = step(s, lam)
    jax.block_until_ready((s, chi))

    s = state0
    with jax.profiler.trace(args.out):
        for _ in range(ITERS):
            s, chi = step(s, lam)
        jax.block_until_ready((s, chi))
    report(args.out, op_names(hlo), SCOPE, ITERS, dev.device_kind)


def report(out, ops, scope, iters, kind):
    paths = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                             recursive=True))
    summary = reduce_trace(paths[-1], ops, scope, iters)
    summary["device_kind"] = kind
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for k, v in summary.items():
        if k != "device_lines":
            print(f"{k}: {v}", flush=True)


if __name__ == "__main__":
    main()
