"""On-device per-bp occupancy: alpha-grid MLE + likelihood-ratio CI.

Device analogue of reference:nucleoatac/Occupancy.py ::
calculateOccupancy/OccupancyCalcParams (SURVEY.md §3.2), restructured for
matrix products (DESIGN.md §4): instead of per-position python loops over a size
histogram, project the whole [B, S, W] count matrix through the [S, G]
log-mixture table with one matmul, then turn the per-position window sum
into a cumulative-sum difference (linearity of the sliding window).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class OccOut(NamedTuple):
    occ: jax.Array  # [B, W]
    lower: jax.Array  # [B, W]
    upper: jax.Array  # [B, W]
    n: jax.Array  # [B, W] fragment counts in window
    # f64-equality certification margins (DESIGN.md §4): a position whose
    # argmax margin AND CI-boundary margin both exceed the device error
    # bound provably selects the same grid values as the float64 mirror;
    # the rest are re-finished in f64 on host (models/occ.py)
    margin: jax.Array  # [B, W] llmax - second-best LL
    ci_margin: jax.Array  # [B, W] min_g |ll_g - (llmax - ci_drop)|


def _sliding_sum(x: jax.Array, flank: int) -> jax.Array:
    """Sliding sum over axis 1 of [B, W, G] with window [p-flank, p+flank],
    zero outside bounds.

    Summed directly per window (reduce_window), NOT as a cumsum difference:
    cumulative sums grow with W and the windowed difference then suffers
    catastrophic cancellation in f32 (observed ~1e-2 abs error on LL ~1e2).
    """
    return jax.lax.reduce_window(
        x,
        jnp.float32(0.0),
        jax.lax.add,
        window_dimensions=(1, 2 * flank + 1, 1),
        window_strides=(1, 1, 1),
        padding=((0, 0), (flank, flank), (0, 0)),
    )


def occupancy_packed(
    mat: jax.Array,  # [B, S, W] float32 counts (integer-valued)
    log_mix: jax.Array,  # [S, G] float32
    flank: int,
    ci_drop: float = 1.92,
    exact_tol: float = 0.05,
) -> jax.Array:
    """Wire-optimized occupancy finisher: ONE uint8 [B, 4, W] output.

    Channels: 0 = argmax grid index, 1 = CI-lower index, 2 = CI-upper
    index, 3 = certified flag (both LL margins clear ``exact_tol`` —
    DESIGN.md §4 — or the window is empty). Occupancy values live on the
    discrete alpha grid, so grid INDICES are the lossless wire format:
    the host decodes with the float64 grid (models/occ.py), which also
    replaces the f32->grid snapping step. One uint8 array per batch
    replaces the six separate f32 downloads of :func:`occupancy_batch`."""
    if log_mix.shape[1] > 256:
        raise ValueError(
            f"grid size {log_mix.shape[1]} > 256 overflows the uint8 "
            "grid-index wire format; use occupancy_batch instead"
        )
    ll, n = _ll_and_n(mat, log_mix, flank)
    best = jnp.argmax(ll, axis=-1)
    llmax = jnp.max(ll, axis=-1)
    ok = ll >= (llmax[..., None] - ci_drop)
    G = log_mix.shape[1]
    first = jnp.argmax(ok, axis=-1)
    last = G - 1 - jnp.argmax(ok[..., ::-1], axis=-1)

    is_best = jax.nn.one_hot(best, G, dtype=jnp.bool_)
    ll2 = jnp.max(jnp.where(is_best, -jnp.inf, ll), axis=-1)
    margin = llmax - ll2
    thr = llmax[..., None] - ci_drop
    ci_margin = jnp.min(jnp.abs(ll - thr), axis=-1)

    empty = n <= 0
    certified = ((margin > exact_tol) & (ci_margin > exact_tol)) | empty
    out = jnp.stack(
        [
            jnp.where(empty, 0, best),
            jnp.where(empty, 0, first),
            jnp.where(empty, G - 1, last),
            certified.astype(jnp.int32),
        ],
        axis=1,
    )
    return out.astype(jnp.uint8)


def occupancy_packed3(
    mat: jax.Array,  # [B, S, W] float32 counts (integer-valued)
    log_mix: jax.Array,  # [S, G] float32
    flank: int,
    core_lo: int,
    core_len: int,
    ci_drop: float = 1.92,
    exact_tol: float = 0.05,
) -> jax.Array:
    """Wire format v2: ONE uint8 [B, 3, core_len] download per batch.

    Channels: 0 = argmax grid index | certified-flag << 7, 1 = CI-lower
    index, 2 = CI-upper index — sliced to the window core
    ``[core_lo, core_lo + core_len)`` (halo columns are never written to
    output tracks, so shipping them wasted ~1/3 of the download).
    Requires grid size <= 128 (7-bit index).
    Decoded on host with the float64 grid (models/occ.py) — lossless, as
    occupancy values live on the discrete alpha grid."""
    G = log_mix.shape[1]
    if G > 128:
        raise ValueError(
            f"grid size {G} > 128 overflows the 7-bit packed grid index; "
            "use occupancy_batch instead"
        )
    ll, n = _ll_and_n(mat, log_mix, flank)
    ll = ll[:, core_lo : core_lo + core_len]
    n = n[:, core_lo : core_lo + core_len]
    best = jnp.argmax(ll, axis=-1)
    llmax = jnp.max(ll, axis=-1)
    ok = ll >= (llmax[..., None] - ci_drop)
    first = jnp.argmax(ok, axis=-1)
    last = G - 1 - jnp.argmax(ok[..., ::-1], axis=-1)

    is_best = jax.nn.one_hot(best, G, dtype=jnp.bool_)
    ll2 = jnp.max(jnp.where(is_best, -jnp.inf, ll), axis=-1)
    margin = llmax - ll2
    thr = llmax[..., None] - ci_drop
    ci_margin = jnp.min(jnp.abs(ll - thr), axis=-1)

    empty = n <= 0
    certified = ((margin > exact_tol) & (ci_margin > exact_tol)) | empty
    ch0 = jnp.where(empty, 0, best) | (certified.astype(jnp.int32) << 7)
    out = jnp.stack(
        [ch0, jnp.where(empty, 0, first), jnp.where(empty, G - 1, last)],
        axis=1,
    )
    return out.astype(jnp.uint8)


def occupancy_packed2(
    mat: jax.Array,  # [B, S, W] float32 counts (integer-valued)
    log_mix: jax.Array,  # [S, G] float32
    flank: int,
    core_lo: int,
    core_len: int,
    ci_drop: float = 1.92,
    exact_tol: float = 0.05,
    return_ll: bool = False,
):
    """Wire format v8: ONE uint8 [B, 2*core_len + ceil(core_len/4)]
    download per batch — 2.25 bytes/bp (v4 was 2 with 4-bit CI deltas).

    Layout: bytes [0, core_len) = argmax grid index | certified << 7;
    bytes [core_len, 2*core_len) = low nibbles of the CI deltas
    (argmax - CI-lower) | (CI-upper - argmax) << 4; the trailing
    ceil(core_len/4) bytes pack each position's FIFTH delta bits, 2 bits
    per position (bit0 = lo_d bit 4, bit1 = up_d bit 4), 4 positions per
    byte, little-endian within the byte.

    Round-4's 4-bit deltas overflowed whenever a CI spanned >15 grid
    steps — which DOMINATES at low coverage (~30 frags/window: 89% of
    positions flagged, VERDICT r4 weak #2), flooding the host f64
    refinisher exactly where windows are cheapest to certify. 5-bit
    deltas (<=31 grid steps) cover essentially every margin-certifiable
    CI (measured round 5: 5-bit recovers 81% certification at tol=1e-3
    on the low-coverage synth vs 17% for 4-bit; 7-bit adds <2% more).
    A delta that still overflows clears the certified flag and routes
    the position through the host float64 refinisher (models/occ.py ::
    _exact_refinish) — the same fallback that guarantees f64-equality at
    near-tie positions, so the format stays lossless end-to-end. Empty
    windows (n == 0) are likewise left uncertified (their upper bound is
    1.0 == grid index G-1, not delta-representable); the refinisher
    emits the 0/0/1 convention for them. REQUIRES occ.exact mode;
    without a refinisher, use occupancy_packed3.

    ``return_ll`` also returns the f32 log-likelihood surface [B,
    core_len, G] the certified flags were decided on (models/selfcheck.py
    compares it with the float64 mirror)."""
    G = log_mix.shape[1]
    if G > 128:
        raise ValueError(
            f"grid size {G} > 128 overflows the 7-bit packed grid index; "
            "use occupancy_batch instead"
        )
    ll, n = _ll_and_n(mat, log_mix, flank)
    ll = ll[:, core_lo : core_lo + core_len]
    n = n[:, core_lo : core_lo + core_len]
    best = jnp.argmax(ll, axis=-1)
    llmax = jnp.max(ll, axis=-1)
    ok = ll >= (llmax[..., None] - ci_drop)
    first = jnp.argmax(ok, axis=-1)
    last = G - 1 - jnp.argmax(ok[..., ::-1], axis=-1)

    is_best = jax.nn.one_hot(best, G, dtype=jnp.bool_)
    ll2 = jnp.max(jnp.where(is_best, -jnp.inf, ll), axis=-1)
    margin = llmax - ll2
    thr = llmax[..., None] - ci_drop
    ci_margin = jnp.min(jnp.abs(ll - thr), axis=-1)

    lo_d = best - first
    up_d = last - best
    empty = n <= 0
    certified = (
        (margin > exact_tol)
        & (ci_margin > exact_tol)
        & (lo_d <= 31)
        & (up_d <= 31)
        & ~empty
    )
    ch0 = jnp.where(empty, 0, best) | (certified.astype(jnp.int32) << 7)
    lo_c = jnp.minimum(lo_d, 31)
    up_c = jnp.minimum(up_d, 31)
    ch1 = jnp.where(empty, 0, (lo_c & 0xF) | ((up_c & 0xF) << 4))
    hi2 = jnp.where(empty, 0, (lo_c >> 4) | ((up_c >> 4) << 1))  # 2 bits
    B = mat.shape[0]
    pad = (-core_len) % 4
    if pad:
        hi2 = jnp.concatenate(
            [hi2, jnp.zeros((B, pad), hi2.dtype)], axis=1
        )
    h = hi2.reshape(B, -1, 4)
    hib = h[:, :, 0] | (h[:, :, 1] << 2) | (h[:, :, 2] << 4) | (h[:, :, 3] << 6)
    packed = jnp.concatenate([ch0, ch1, hib], axis=1).astype(jnp.uint8)
    return (packed, ll) if return_ll else packed


def _ll_and_n(mat, log_mix, flank):
    """[B, W, G] window log-likelihood surface + [B, W] window counts."""
    # HIGHEST keeps full f32 products: below it, f32 matmuls may run
    # with reduced-precision operands (TF32 on a GPU), and this einsum is
    # then the dominant device error term. |LL_f32 - LL_f64| has to stay
    # well under OccParams.exact_tol, because the argmax margin at
    # exact_tol bounds the certification rate at low coverage (tol 5e-3
    # certifies 35% of a 30-frags/window synth, 1e-3 certifies 83%).
    # chip_smoke.py phase b measures the error on the card.
    proj = jnp.einsum(
        "bsw,sg->bwg", mat, log_mix, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    ll = _sliding_sum(proj, flank)  # [B, W, G]
    n = _sliding_sum(mat.sum(axis=1)[..., None], flank)[..., 0]  # [B, W]
    return ll, n


def occupancy_batch(
    mat: jax.Array,  # [B, S, W] float32 counts (integer-valued)
    log_mix: jax.Array,  # [S, G] float32
    alpha_grid: jax.Array,  # [G] float32
    flank: int,
    ci_drop: float = 1.92,
) -> OccOut:
    ll, n = _ll_and_n(mat, log_mix, flank)

    best = jnp.argmax(ll, axis=-1)  # first occurrence on ties
    llmax = jnp.max(ll, axis=-1)
    ok = ll >= (llmax[..., None] - ci_drop)
    G = alpha_grid.shape[0]
    first = jnp.argmax(ok, axis=-1)
    last = G - 1 - jnp.argmax(ok[..., ::-1], axis=-1)

    occ = jnp.take(alpha_grid, best)
    lo = jnp.take(alpha_grid, first)
    up = jnp.take(alpha_grid, last)

    is_best = jax.nn.one_hot(best, G, dtype=jnp.bool_)
    ll2 = jnp.max(jnp.where(is_best, -jnp.inf, ll), axis=-1)
    margin = llmax - ll2
    thr = llmax[..., None] - ci_drop
    ci_margin = jnp.min(jnp.abs(ll - thr), axis=-1)

    empty = n <= 0
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    return OccOut(
        occ=jnp.where(empty, 0.0, occ),
        lower=jnp.where(empty, 0.0, lo),
        upper=jnp.where(empty, 1.0, up),
        n=n,
        # empty windows are exact by definition
        margin=jnp.where(empty, big, margin),
        ci_margin=jnp.where(empty, big, ci_margin),
    )
