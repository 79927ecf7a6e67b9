"""On-device V-plot rasterization: fragment lists -> [B, S, W] count mats.

Device analogue of reference:pyatac/chunkmat2d.py :: FragmentMat2D
.makeFragmentMat (SURVEY.md §3.1), which scatter-increments (size,
midpoint) cells while iterating pysam reads. Here fragments arrive as
padded fixed-shape (midpoint, size) int32 tensors (DESIGN.md §10) and ONE
flattened scatter-add over [B*S*W] builds all window matrices at once.

Fragment lists are ~200x smaller than the dense count matrices on the
host->device link, so this is the production transfer format
(models/data.py::make_batches); host rasterization (make_dense_batches)
remains as a fallback.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_fragments(packed: jax.Array):
    """Unpack [B, F] int32 `(size << 16) | mid` fragment words.

    The packed word is the production host->device wire format
    (models/data.py :: pack_fragments): one array instead of three
    (mids/sizes/valid), halving transfer bytes and cutting per-batch
    transfer count 3x — the host->device link is the pipeline bottleneck
    (DESIGN.md §10). size == 0 marks padding, so validity costs no bits.
    """
    mids = packed & 0xFFFF
    sizes = packed >> 16  # packed is non-negative: arithmetic shift is safe
    return mids, sizes, sizes > 0


def unpack_delta_fragments(db: jax.Array):
    """Unpack [B, F, 2] uint8 delta-coded fragments (the 2-byte wire
    format, models/data.py :: encode_delta_fragments).

    Entry i is `(delta_i, size_i)`: window-relative midpoints are the
    running sum of deltas along the fragment axis (fragments arrive
    midpoint-sorted from ingest, so deltas are tiny — uint8 suffices,
    with `(255, 0)` skip entries splitting the rare gap > 255 bp).
    `size == 0` marks padding AND skip entries, so both decode to
    invalid for free. Halves the wire bytes of the int32 packed-word
    format — the host->device link is the pipeline bottleneck
    (DESIGN.md §10), so this is ~2x end-to-end windows/s.
    """
    d = db[..., 0].astype(jnp.int32)
    s = db[..., 1].astype(jnp.int32)
    mids = jnp.cumsum(d, axis=1)
    return mids, s, s > 0


def unpack_delta12_fragments(buf: jax.Array, n_entries: int):
    """Unpack the 12-bit/record upload format (wire v6,
    models/data.py :: encode_delta12_fragments).

    ``buf`` is uint8 [B, ceil(E/2) + E]: a nibble-packed delta plane
    (2 records/byte, low nibble first) followed by the size-byte plane.
    A record advances the running midpoint by ``d`` (size s in [1, 255]:
    a real fragment) or by ``d * 15`` (s == 0: a skip record splitting
    gaps > 14 bp; also zero padding, which advances 0). 1.5 bytes per
    record vs the 2-byte (delta, size) pair format."""
    E = n_entries
    nib_bytes = (E + 1) // 2
    nib = buf[:, :nib_bytes].astype(jnp.int32)
    d = jnp.stack([nib & 0xF, nib >> 4], axis=-1).reshape(
        buf.shape[0], -1
    )[:, :E]
    s = buf[:, nib_bytes : nib_bytes + E].astype(jnp.int32)
    adv = jnp.where(s == 0, d * 15, d)
    mids = jnp.cumsum(adv, axis=1)
    return mids, s, s > 0


def rasterize_delta12_batch(
    buf: jax.Array, n_entries: int, lower: int, upper: int, width: int
) -> jax.Array:
    """Wire-v6 upload decode + rasterize (see unpack_delta12_fragments)."""
    mids, sizes, valid = unpack_delta12_fragments(buf, n_entries)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def rasterize_delta_batch(
    db: jax.Array, lower: int, upper: int, width: int
) -> jax.Array:
    """[B, F, 2] uint8 delta-coded fragments -> [B, upper-lower, width]
    f32 counts. Requires upper <= 255 (uint8 size field; the encoder
    saturates sizes >= 255 to 255, which this drops as out-of-range only
    while upper <= 255 — enforced in config.RunConfig.__post_init__)."""
    mids, sizes, valid = unpack_delta_fragments(db)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def unpack_pool_fragments(pool: jax.Array, table: jax.Array, emax: int):
    """Chunk-resident fragment pool decode (wire v7, round-4 VERDICT
    item 4): fragments upload ONCE per chunk as a shared 12-bit/record
    stream; each window carries only a 12-byte table row into it — no
    per-batch re-upload, no halo duplication between a chunk's
    overlapping windows, no per-batch host encode.

    pool: [cap//2 + cap] uint8 — a nibble-packed delta plane (2 records
    per byte, low nibble first) followed by the size-byte plane, with the
    SAME record semantics as wire v6 (unpack_delta12_fragments): size in
    [1, 255] = fragment advancing by its nibble (0..14), size 0 = skip
    advancing nibble*15. cap is recovered from the pool length
    (len = 3*cap/2). table: [B, 3] int32 ``(rec_start, rec_count, base)``
    with rec_start EVEN (nibble-byte aligned; the host extends a window's
    range down one record when needed — the extra leading record decodes
    to a midpoint left of the window and is masked by the raster).
    ``base`` is the window-relative position the first record's advance
    extends. emax: static even gather width (>= max rec_count).

    Returns (mids, sizes, valid) exactly like the per-window formats —
    the downstream programs are shared, so pool outputs are bitwise
    identical (tests/test_transfer.py)."""
    cap = 2 * pool.shape[0] // 3
    nb = cap // 2
    rs = table[:, 0:1]
    ar2 = jnp.arange(emax // 2, dtype=jnp.int32)[None, :]
    nib = jnp.take(
        pool, jnp.clip((rs >> 1) + ar2, 0, nb - 1), axis=0
    ).astype(jnp.int32)  # [B, emax//2]
    d = jnp.stack([nib & 0xF, nib >> 4], axis=-1).reshape(
        table.shape[0], emax
    )
    ar = jnp.arange(emax, dtype=jnp.int32)[None, :]
    s = jnp.take(
        pool, nb + jnp.clip(rs + ar, 0, cap - 1), axis=0
    ).astype(jnp.int32)
    in_cnt = ar < table[:, 1:2]
    d = jnp.where(in_cnt, d, 0)
    s = jnp.where(in_cnt, s, 0)
    adv = jnp.where(s == 0, d * 15, d)
    mids = table[:, 2:3] + jnp.cumsum(adv, axis=1)
    return mids, s, s > 0


def rasterize_pool_batch(
    pool: jax.Array, table: jax.Array, emax: int, lower: int, upper: int,
    width: int,
) -> jax.Array:
    """Pool-resident fragments -> [B, upper-lower, width] f32 counts."""
    mids, sizes, valid = unpack_pool_fragments(pool, table, emax)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def rasterize_packed_batch(
    packed: jax.Array, lower: int, upper: int, width: int
) -> jax.Array:
    """[B, F] packed fragment words -> [B, upper-lower, width] f32 counts."""
    mids, sizes, valid = unpack_fragments(packed)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def rasterize_batch(
    mids: jax.Array,  # [B, F] window-relative midpoints; invalid: any value
    sizes: jax.Array,  # [B, F] adjusted sizes; invalid rows marked by valid
    valid: jax.Array,  # [B, F] bool
    lower: int,
    upper: int,
    width: int,
) -> jax.Array:
    """Returns [B, upper-lower, width] float32 counts.

    Fragments outside the size/window range are dropped (mask folded into
    the scatter update so shapes stay static).
    """
    B, F = mids.shape
    S = upper - lower
    keep = (
        valid
        & (mids >= 0)
        & (mids < width)
        & (sizes >= lower)
        & (sizes < upper)
    )
    s_rel = jnp.clip(sizes - lower, 0, S - 1)
    m = jnp.clip(mids, 0, width - 1)
    b_idx = jax.lax.broadcasted_iota(jnp.int32, (B, F), 0)
    flat_idx = (b_idx * S + s_rel) * width + m  # [B, F] in [0, B*S*W)
    upd = keep.astype(jnp.float32)
    z = jnp.zeros((B * S * width,), jnp.float32)
    z = z.at[flat_idx.reshape(-1)].add(upd.reshape(-1))
    return z.reshape(B, S, width)
