"""On-device expected-fragment (bias) matrix construction.

Device analogue of reference:pyatac/chunkmat2d.py :: BiasMat2D.makeBiasMat
(SURVEY.md §3.1): B0[s, p] = q(s) * exp(B[left] + B[right]) / core row sum,
with left = p - (s-1)//2, right = p + s//2 (DESIGN.md §6).

Implementation note: each size row is the per-bp track shifted by a
constant, built with a lax.scan over sizes whose body does two dynamic
slices of a zero-padded track — ONE compiled body instead of S unrolled
slices, which keeps the program small.
Zero padding = neutral log-bias outside the window, matching the mirror.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def bias_mat_batch(
    log_bias: jax.Array,  # [B, W] per-bp log insertion bias
    size_probs: jax.Array,  # [S] genome-wide nuc-range size distribution
    lower: int,
    upper: int,
    core_lo: int,
    core_hi: int,
) -> jax.Array:
    """Returns [B, S, W] float32 B0."""
    W = log_bias.shape[1]
    sizes = np.arange(lower, upper)
    left_start = -((sizes - 1) // 2)  # shift applied to position index
    right_start = sizes // 2
    pmax = int(max(np.abs(left_start).max(), np.abs(right_start).max())) + 1
    padded = jnp.pad(log_bias, ((0, 0), (pmax, pmax)))
    starts = jnp.asarray(
        np.stack([pmax + left_start, pmax + right_start], axis=1), jnp.int32
    )  # [S, 2]

    def body(_, st):
        bl = jax.lax.dynamic_slice_in_dim(padded, st[0], W, axis=1)
        br = jax.lax.dynamic_slice_in_dim(padded, st[1], W, axis=1)
        return None, jnp.exp(bl + br)  # [B, W]

    _, rows = jax.lax.scan(body, None, starts)  # [S, B, W]
    raw = jnp.swapaxes(rows, 0, 1)  # [B, S, W]
    core_sum = raw[:, :, core_lo:core_hi].sum(axis=2)  # [B, S]
    core_sum = jnp.where(core_sum > 0, core_sum, 1.0)
    return raw * (size_probs[None, :] / core_sum)[..., None]
