"""Template cross-correlation conv stack: signal/background/variance/LR/fuzz.

This is the heart of the tool — the device rebuild of
reference:nucleoatac/NucleosomeCalling.py (scipy 2-D xcorrs) and
reference:nucleoatac/multinomial_cov.pyx (the Cython sliding multinomial
variance) — SURVEY.md §3.2/§4.2. All seven footprint reductions of
DESIGN.md §7 are 1-D convolutions over position with S size-channels, so
they are computed as TWO XLA convolutions (one over the fragment matrix,
one over the bias matrix) whose output channels are the stacked kernels,
followed by elementwise math.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Matmul precision of every nuc conv (f32 operands). On a GPU, XLA lets
# DEFAULT and HIGH run f32 products in TF32 (10-bit mantissa), which puts
# |norm_f32 - norm_f64| above the 4x margin under NucParams.exact_tol that
# the certification layer needs (chip_smoke.py phase b measures both);
# HIGHEST keeps full f32 products. On the CPU all three are f32.
CONV_PRECISION = jax.lax.Precision.HIGHEST


class NucScoresOut(NamedTuple):
    signal: jax.Array  # [B, W]
    n: jax.Array
    exp_signal: jax.Array
    var: jax.Array
    norm: jax.Array
    lr: jax.Array
    fuzz: jax.Array


def build_kernels(vmat: np.ndarray, v_floor: float = 1e-5):
    """Host-side: stack conv kernels from the [S, K] template.

    F-side kernels (5): V, ones, log(max(V, floor)), offs, offs^2.
    B-side kernels (3): ones, V, V^2.
    Returned as float32 [out_ch, S, K] arrays.
    """
    S, K = vmat.shape
    ones = np.ones((S, K))
    logv = np.log(np.maximum(vmat, v_floor))
    offs = np.broadcast_to((np.arange(K, dtype=np.float64) - K // 2)[None, :], (S, K))
    fk = np.stack([vmat, ones, logv, offs, offs * offs]).astype(np.float32)
    bk = np.stack([ones, vmat, vmat * vmat]).astype(np.float32)
    # returned as HOST numpy: these are closed over by jitted programs,
    # and numpy constants embed at trace time without a device fetch
    return fk, bk


def _conv_stack(
    x: jax.Array, kern: jax.Array, precision=CONV_PRECISION
) -> jax.Array:
    """[B, S, W] (x) [C, S, K] -> [B, C, W-K+1] valid cross-correlation."""
    return jax.lax.conv_general_dilated(
        x,
        kern,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=precision,
    )


def build_kernels_diag(vmat: np.ndarray, v_floor: float = 1e-5):
    """Kernel tables for the diag-matmul conv path (see conv_stack_diag).

    Of the eight footprint reductions, only four have genuine 2-D
    structure (V and log V against the fragment matrix; V and V^2 against
    the bias matrix) — the other four (ones, offs, offs^2 on fragments;
    ones on bias) are constant along the size axis, so they reduce to
    1-D convolutions of the COLUMN SUMS, at 1/S the FLOPs. Returns
    (f2d [2, K, S], f1d [3, K], b2d [2, K, S], b1d [1, K]) host float32.
    """
    S, K = vmat.shape
    logv = np.log(np.maximum(vmat, v_floor))
    f2d = np.stack([vmat.T, logv.T]).astype(np.float32)  # [2, K, S]
    b2d = np.stack([vmat.T, (vmat * vmat).T]).astype(np.float32)
    offs = np.arange(K, dtype=np.float64) - K // 2
    f1d = np.stack([np.ones(K), offs, offs * offs]).astype(np.float32)
    b1d = np.ones((1, K), dtype=np.float32)
    return f2d, f1d, b2d, b1d


def conv_stack_diag(
    x: jax.Array,  # [B, S, W]
    k2d: jax.Array,  # [C, K, S]
    precision=CONV_PRECISION,
) -> jax.Array:
    """[B, C, W-K+1] valid xcorr of C 2-D kernels as one batched GEMM.

    The direct conv formulation contracts S*K-long rows into only C<=5
    output channels, a shape matrix units run poorly. Restructured as
    H[b,ck,w] = sum_s kflat[ck,s] * x[b,s,w]: the einsum form
    'ks,bsw->bkw' keeps x[b] as the [S, W] matmul operand, so XLA emits a
    transpose-free batched GEMM. The output is then the diagonal sum
    out[j] = sum_k H[k, j+k]. H is [B, C*K, W] f32 (115 MB per stack at
    B=64, K=147, W=1536) and round-trips device memory."""
    B, S, W = x.shape
    C, K, S2 = k2d.shape
    assert S2 == S
    Wo = W - K + 1
    kflat = k2d.reshape(C * K, S)
    H = jnp.einsum(
        "ks,bsw->bkw", kflat, x,
        preferred_element_type=jnp.float32, precision=precision,
    ).reshape(B, C, K, W)
    # unrolled static diagonal slices, summed as a balanced tree: XLA
    # fuses the K-term sum into one pass over H without a deep serial
    # add chain or the layout copies of a pad+reshape skew
    terms = [H[:, :, k, k : k + Wo] for k in range(K)]
    while len(terms) > 1:
        nxt = [
            terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)
        ]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def conv1d_stack(
    x: jax.Array,  # [B, W]
    kerns: jax.Array,  # [C, K]
    precision=CONV_PRECISION,
) -> jax.Array:
    """[B, C, W-K+1] valid xcorr of 1-D kernels against per-bp sums."""
    return jax.lax.conv_general_dilated(
        x[:, None, :],
        kerns[:, None, :],
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=precision,
    )


def nuc_conv_outputs_diag(
    frag_mat: jax.Array,  # [B, S, W]
    b0: jax.Array,  # [B, S, W]
    f2d: jax.Array,
    f1d: jax.Array,
    b2d: jax.Array,
    b1d: jax.Array,
    precision=CONV_PRECISION,
):
    """Drop-in replacement for the two direct conv stacks: returns
    (fo [B, 5, W-K+1], bo [B, 3, W-K+1]) in the channel order
    (signal, n, flogv, foff, foff2) / (bsum, vb, v2b)."""
    f2 = conv_stack_diag(frag_mat, f2d, precision)  # signal, flogv
    b2 = conv_stack_diag(b0, b2d, precision)  # vb, v2b
    f1 = conv1d_stack(frag_mat.sum(axis=1), f1d, precision)  # n, foff, foff2
    b1 = conv1d_stack(b0.sum(axis=1), b1d, precision)  # bsum
    fo = jnp.concatenate(
        [f2[:, :1], f1[:, :1], f2[:, 1:2], f1[:, 1:3]], axis=1
    )
    bo = jnp.concatenate([b1, b2], axis=1)
    return fo, bo


def nuc_scores_batch(
    frag_mat: jax.Array,  # [B, S, W] float32
    b0: jax.Array,  # [B, S, W] float32
    f_kernels: jax.Array,  # [5, S, K]
    b_kernels: jax.Array,  # [3, S, K]
    var_floor: float = 1e-12,
) -> NucScoresOut:
    K = f_kernels.shape[2]
    half = K // 2
    W = frag_mat.shape[2]

    fo = _conv_stack(frag_mat, f_kernels)  # [B, 5, W-K+1]
    bo = _conv_stack(b0, b_kernels)  # [B, 3, W-K+1]

    pad = ((0, 0), (0, 0), (half, W - half - (W - K + 1)))
    fo = jnp.pad(fo, pad)
    bo = jnp.pad(bo, pad)
    # Keep the conv stage and the elementwise normalization in separate
    # fusions, as in the chained production path (models/engine.py), so
    # this monolithic form is comparable with it; the barrier costs one
    # device-memory round trip of the [B, 8, W] conv outputs.
    fo, bo = jax.lax.optimization_barrier((fo, bo))

    signal, n, flogv, foff, foff2 = (fo[:, i] for i in range(5))
    bsum, vb, v2b = (bo[:, i] for i in range(3))

    safe_b = jnp.where(bsum > 0, bsum, 1.0)
    mu = vb / safe_b
    mu2 = v2b / safe_b
    exp_signal = n * mu
    var = n * (mu2 - mu * mu)
    ok = (var > var_floor) & (n > 0)
    norm = jnp.where(ok, (signal - exp_signal) * jax.lax.rsqrt(jnp.where(ok, var, 1.0)), 0.0)
    lr = jnp.where(n > 0, flogv - n * jnp.log(jnp.maximum(mu, 1e-30)), 0.0)
    safe_n = jnp.where(n > 0, n, 1.0)
    m1 = foff / safe_n
    m2 = foff2 / safe_n
    fuzz = jnp.where(n > 0, jnp.sqrt(jnp.maximum(m2 - m1 * m1, 0.0)), 0.0)
    return NucScoresOut(signal, n, exp_signal, var, norm, lr, fuzz)
