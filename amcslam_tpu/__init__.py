"""amcslam_tpu — asynchronous multi-camera SLAM on an accelerator, in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of AMC-SLAM
(continuous-time multi-camera SLAM with sparse-GP motion priors, built on
ORB-SLAM3). The numerical backend — Lie-group kernels, GP interpolation,
factor residuals/Jacobians, a g2o-semantics Levenberg-Marquardt solver with
landmark Schur complement — runs as batched, jitted device programs.

Layout:
  ops/       Lie groups (SO3/SE3/Sim3) and sparse-GP motion-prior kernels
  factors/   residual + analytic-Jacobian factor library (SoA, vmap-first)
  solver/    LM driver, robust kernels, Schur-complement BA problems
  ransac/    batched minimal solvers (Horn Sim3, velocity RANSAC, ...)
  parallel/  multi-device sharding of the factor-graph linearization
  frontend/  camera models and host-side feature plumbing
  utils/     synthetic problem generators, config, trajectory IO
"""

__version__ = "0.1.0"

import jax as _jax

# SLAM geometry is precision-critical: on the GPU, XLA may run f32 matmuls in
# TF32 (10 mantissa bits), which injects ~1e-3 relative error into 4x4 pose
# compositions, far above the chi2-parity budget, and breaks the exactness
# of the one-hot gathers (solver/ba.py _onehot_gather). Default the whole
# framework to true-f32 matmuls; a large matmul that tolerates TF32 has to
# opt into it explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the pipeline jits one program per padded
# problem bucket (pose solve, local BA, ...); caching them across processes
# removes the dominant cold-start cost of a run. The cache lives in
# $JAX_COMPILATION_CACHE_DIR when that is set, else in <checkout>/.jax_cache,
# so a copied tree keeps its cache inside itself. Opt out by setting
# AMCSLAM_NO_COMPILE_CACHE (e.g. when the checkout is not writable).
import os as _os

if not _os.environ.get("AMCSLAM_NO_COMPILE_CACHE"):
    _cache = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )
    try:
        _os.makedirs(_cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError:
        pass
