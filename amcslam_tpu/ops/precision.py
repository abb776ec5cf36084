"""Matmul-precision control for geometry kernels.

On the GPU, XLA may run f32 matmuls in TF32 (10 mantissa bits), which is
catastrophic for Lie-group and GP-kernel algebra: Qi @ Phi^T @ QiInv mixes
O(dt^3) and O(1/dt^3) magnitudes and loses ~1e-3 accuracy in the
interpolated pose. All small geometry matmuls therefore run at HIGHEST
precision — they are tiny (<= 12x12) so tensor-core throughput is
irrelevant, and the one-hot gathers (solver/ba.py _onehot_gather) are exact
only at HIGHEST.
"""

from __future__ import annotations

import functools

import jax


def exact(fn):
    """Decorator: run fn with full-f32 (HIGHEST) matmul precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def smm(a, b):
    """Small-matrix multiply as broadcast multiply + sum.

    For the fixed tiny operands of Lie/GP/factor chains (<= 12x12), a
    dot_general becomes a separate library call that blocks XLA elementwise
    fusion; the mul-sum form is exact f32 and fuses with its neighbors.
    Handles matrix @ matrix and matrix @ vector with arbitrary broadcast
    batch dims.
    """
    import jax.numpy as jnp

    if b.ndim == a.ndim - 1:  # matrix @ vector
        return jnp.sum(a * b[..., None, :], axis=-1)
    # out[..., i, j] = sum_k a[..., i, k] b[..., k, j]
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def fdtype():
    """Canonical max-precision float dtype for host->device problem uploads:
    float64 when x64 is enabled (CPU test mesh), else float32 (requesting
    f64 without x64 would only emit a truncation warning per call site)."""
    import jax.numpy as jnp

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
