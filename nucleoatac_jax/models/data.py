"""Host data layer: fixed-shape window batching over peak chunks.

The reference partitions peak windows across a multiprocessing pool
(reference:run_occ.py/run_nuc.py pool setup — SURVEY.md §3.3); here peaks
are tiled into fixed cores + halos and packed into regular [B, F] fragment
tensors for batched device execution (DESIGN.md §10). Fragment capacity F
is bucketed to powers of two so jit recompiles at most a handful of times.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from nucleoatac_jax.config import OccParams, RunConfig, VMatParams, WindowParams
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.io.bam import BamFragments


@dataclass
class TileMeta:
    chunk_id: int
    chrom: str
    core_start: int
    core_end: int
    win_start: int  # genomic position of window column 0 (may be < 0)


@dataclass
class WindowBatch:
    mids: np.ndarray  # [B, F] int32, window-relative midpoints
    sizes: np.ndarray  # [B, F] int32
    valid: np.ndarray  # [B, F] bool
    meta: List[TileMeta]  # length <= B; rows past len(meta) are padding


@dataclass
class PackedBatch:
    """Production wire format: ONE int32 array per batch instead of three.

    Each word is `(size << 16) | mid` with size == 0 marking padding
    (ops/rasterize.py :: unpack_fragments). Fragment sizes are < 2^15 and
    window-relative midpoints < 2^16 by construction (ingest caps sizes;
    window width is ~2 kbp), so the pack is lossless. Halves the
    host->device bytes of WindowBatch and cuts the per-batch transfer
    count 3x.
    """

    packed: np.ndarray  # [B, F] int32
    meta: List[TileMeta]


def pack_fragments(
    mids: np.ndarray, sizes: np.ndarray, out: np.ndarray, row: int
) -> None:
    """Pack one window's (mid, size) lists into out[row, :n]."""
    n = len(mids)
    s = np.minimum(sizes.astype(np.int32), 0x7FFF)
    out[row, :n] = (s << 16) | mids.astype(np.int32)


@dataclass
class DeltaBatch:
    """2-byte-per-fragment wire format (production; DESIGN.md §10).

    Entry = `(delta, size)` uint8 pair: midpoints are delta-coded along
    the (already midpoint-sorted) fragment axis, sizes fit uint8 because
    the histogram support caps at 251 (< 256; config.SizesParams). Gaps
    > 255 bp are split with `(255, 0)` skip entries; `size == 0` marks
    skip/padding. Device decode = one cumsum (ops/rasterize.py
    :: unpack_delta_fragments). Halves the bytes of PackedBatch.
    """

    delta: np.ndarray  # [B, F, 2] uint8
    meta: List[TileMeta]


def encode_delta_fragments(
    mids: np.ndarray, sizes: np.ndarray, out: np.ndarray, row: int
) -> int:
    """Delta-encode one window's sorted (mid, size) lists into
    out[row, :n_entries]; returns n_entries (frags + skip entries).

    Preconditions (violations raise): ``mids`` sorted ascending with
    ``mids[0] >= 0``, and ``out[row]`` zeroed beyond the written entries
    (skip/padding entries rely on the buffer's zero size bytes; all
    callers allocate a fresh ``np.zeros`` buffer per batch)."""
    n = len(mids)
    if n == 0:
        return 0
    d = np.diff(mids.astype(np.int64), prepend=0)
    if d.min() < 0:
        raise ValueError(
            "encode_delta_fragments requires midpoint-sorted mids >= 0"
        )
    nskip = d // 255
    total = int(n + nskip.sum())
    pos = np.cumsum(nskip + 1) - 1  # entry index of each real fragment
    out[row, :total, 0] = 255  # skip entries: advance 255, size stays 0
    out[row, pos, 0] = (d - nskip * 255).astype(np.uint8)
    out[row, pos, 1] = np.minimum(sizes, 255).astype(np.uint8)
    return total


def _native_binding():
    """io/native/binding.py (C++ wire encoders), or None when libnucio.so
    is unavailable (io.native.load has logged why)."""
    try:
        from nucleoatac_jax.io.native import binding
    except ImportError:
        return None
    return binding


def encode_delta_batch(
    mids: np.ndarray,
    sizes: np.ndarray,
    out: np.ndarray,
    counts: np.ndarray | None = None,
) -> None:
    """Delta-encode a whole [B, F] batch into the zeroed [B, n_entries, 2]
    uint8 wire buffer. counts[b] = valid fragments in row b (default F).

    Uses the native C++ encoder when libnucio.so is built — the per-row
    numpy path (encode_delta_fragments) costs ~4 ms per 128-window batch,
    a large share of the host cost of the run loop."""
    B, F = mids.shape
    if counts is None:
        counts = np.full(B, F, dtype=np.int64)
    else:
        counts = np.ascontiguousarray(counts, dtype=np.int64)
    native = _native_binding()
    if native is not None and native.HAS_ENCODE_DELTA:
        m32 = np.ascontiguousarray(mids, dtype=np.int32)
        s32 = np.ascontiguousarray(sizes, dtype=np.int32)
        native.encode_delta_native(m32, s32, counts, out)
        return
    for b in range(B):
        n = int(counts[b])
        encode_delta_fragments(mids[b, :n], sizes[b, :n], out, b)


def delta12_entry_capacity(frag_cap: int, width: int) -> int:
    """Record capacity of the wire-v6 upload for a window: fragments plus
    the worst-case skip-record count. Each skip record advances up to
    15*15 = 225 bp, and ceil(u/15) <= u for u >= 1 bounds total skips by
    the total 15-bp unit count, itself <= width // 15. Rounded even so
    the nibble plane splits cleanly."""
    e = frag_cap + width // 15 + 2
    return e + (e % 2)


def encode_delta12_fragments(
    mids: np.ndarray, sizes: np.ndarray, out: np.ndarray, row: int
) -> int:
    """Encode one window's sorted (mid, size) lists into the wire-v6
    12-bit/record buffer row (ops/rasterize.py ::
    unpack_delta12_fragments): out[row] is uint8 [E//2 + E], zeroed —
    nibble-packed delta plane then size-byte plane. Returns the record
    count. A fragment record advances by its nibble (0..14); gaps > 14
    are split into skip records (size byte 0) advancing nibble*15 each.
    1.5 bytes/record vs the 2-byte pair format."""
    M = out.shape[1]
    E = 2 * M // 3
    n = len(mids)
    if n == 0:
        return 0
    d = np.diff(mids.astype(np.int64), prepend=0)
    if d.min() < 0:
        raise ValueError(
            "encode_delta12_fragments requires midpoint-sorted mids >= 0"
        )
    u = d // 15  # 15-bp units the skips must cover
    frag_d = (d - u * 15).astype(np.uint8)  # 0..14
    nskip = -(-u // 15)  # ceil: each skip record carries <= 15 units
    total = int(n + nskip.sum())
    if total > E:
        raise ValueError(
            f"delta12 capacity {E} records < {total} needed; raise frag_cap"
        )
    pos = np.cumsum(nskip + 1) - 1  # record index of each real fragment
    dvals = np.full(total, 15, np.uint8)  # default skip: 15 units = 225 bp
    svals = np.zeros(total, np.uint8)
    dvals[pos] = frag_d
    svals[pos] = np.minimum(sizes, 255).astype(np.uint8)
    has = nskip > 0
    # the skip just before each fragment carries the remainder units
    dvals[pos[has] - 1] = (u - (nskip - 1) * 15)[has].astype(np.uint8)
    dn = np.zeros(E, np.uint8)
    dn[:total] = dvals
    nb = E // 2
    out[row, :nb] = dn[0::2] | (dn[1::2] << 4)
    out[row, nb : nb + total] = svals
    return total


def encode_delta12_batch(
    mids: np.ndarray,
    sizes: np.ndarray,
    out: np.ndarray,
    counts: np.ndarray | None = None,
) -> None:
    """Encode a whole [B, F] batch into the zeroed wire-v6 buffer
    [B, E//2 + E] (native C++ when libnucio.so exports it, else the
    per-row numpy path)."""
    B, F = mids.shape
    if counts is None:
        counts = np.full(B, F, dtype=np.int64)
    else:
        counts = np.ascontiguousarray(counts, dtype=np.int64)
    native = _native_binding()
    if native is not None and native.HAS_ENCODE_DELTA12:
        m32 = np.ascontiguousarray(mids, dtype=np.int32)
        s32 = np.ascontiguousarray(sizes, dtype=np.int32)
        native.encode_delta12_native(m32, s32, counts, out)
        return
    for b in range(B):
        n = int(counts[b])
        encode_delta12_fragments(mids[b, :n], sizes[b, :n], out, b)


def pack_nibble_codes(codes: np.ndarray) -> np.ndarray:
    """[B, wp] uint8 base codes (values 0..4) -> [B, ceil(wp/2)] bytes,
    low nibble first (ops/pwmseq.py :: unpack_nibble_codes)."""
    B, wp = codes.shape
    if wp % 2:
        codes = np.concatenate(
            [codes, np.full((B, 1), 4, dtype=np.uint8)], axis=1
        )
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def pack_2bit_codes(codes: np.ndarray, esc_cap: int = 512):
    """[B, wp] uint8 base codes (0..4) -> (packed [B, ceil(wp/4)] bytes
    with 4 codes/byte little-endian, escapes [esc_cap, 2] int32 (row,
    col) marking code-4 (N / out-of-genome) positions, ok flag).

    Wire v9 sequence plane (round 5, VERDICT r4 item 6): the nibble rows
    were ~100 KB/batch at B=128 — more than the fragment pool itself —
    and DNA needs 2 bits; N positions are shipped as a fixed-capacity
    escape list the device scatters back (ops/pwmseq.py ::
    unpack_2bit_codes). ok=False when a batch has more than esc_cap N
    positions (N-blocks, chrom edges) — the dispatcher falls back to the
    nibble program for that batch. Padded escape entries point at the
    dead column wp."""
    B, wp = codes.shape
    rows, cols = np.nonzero(codes >= 4)
    esc = np.full((esc_cap, 2), (0, wp), np.int32)
    ok = len(rows) <= esc_cap
    if ok and len(rows):
        esc[: len(rows), 0] = rows
        esc[: len(rows), 1] = cols
    pad = (-wp) % 4
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((B, pad), np.uint8)], axis=1
        )
    c = (codes & 3).reshape(B, -1, 4).astype(np.uint8)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (
        c[:, :, 3] << 6
    )
    return packed, esc, ok


@dataclass
class Delta12Batch:
    """Wire-v6 upload: 12 bits per fragment record (4-bit midpoint delta
    nibble-plane + 8-bit size plane; encode_delta12_fragments). ~25%
    fewer upload bytes than DeltaBatch — the upload stream binds e2e
    windows/s once wire v5 shrank the download below it."""

    buf: np.ndarray  # [B, E//2 + E] uint8
    meta: Sequence[TileMeta]


def make_delta12_batches(
    frags: BamFragments,
    tiles: Sequence[TileMeta],
    width: int,
    batch: int,
    frag_cap: int | None = None,
) -> Iterator[Delta12Batch]:
    """Fixed-shape wire-v6 batches (see Delta12Batch)."""
    if frag_cap is None:
        frag_cap = _bucket(max_window_frags(frags, tiles, width))
    E = delta12_entry_capacity(frag_cap, width)
    M = E // 2 + E
    for i in range(0, len(tiles), batch):
        group = list(tiles[i : i + batch])
        buf = np.zeros((batch, M), dtype=np.uint8)
        mids = np.zeros((batch, frag_cap), dtype=np.int32)
        sizes = np.zeros((batch, frag_cap), dtype=np.int32)
        counts = np.zeros(batch, dtype=np.int64)
        for r, t in enumerate(group):
            m, s = frags.window(t.chrom, t.win_start, t.win_start + width)
            if len(m) > frag_cap:
                raise ValueError(
                    f"window at {t.chrom}:{t.win_start} has {len(m)} "
                    f"fragments > frag_cap {frag_cap}; raise frag_cap"
                )
            mids[r, : len(m)] = m - t.win_start
            sizes[r, : len(s)] = s
            counts[r] = len(m)
        encode_delta12_batch(mids, sizes, buf, counts)
        yield Delta12Batch(buf, group)


def make_delta_batches(
    frags: BamFragments,
    tiles: Sequence[TileMeta],
    width: int,
    batch: int,
    frag_cap: int | None = None,
) -> Iterator[DeltaBatch]:
    """Fixed-[B, F, 2] delta-coded batches (see DeltaBatch). The entry
    capacity adds the worst-case skip count (width // 255 + 1) on top of
    the fragment-count bucket so encoding can never overflow."""
    if frag_cap is None:
        frag_cap = _bucket(
            max_window_frags(frags, tiles, width) + width // 255 + 1
        )
    for i in range(0, len(tiles), batch):
        group = list(tiles[i : i + batch])
        db = np.zeros((batch, frag_cap, 2), dtype=np.uint8)
        mids = np.zeros((batch, frag_cap), dtype=np.int32)
        sizes = np.zeros((batch, frag_cap), dtype=np.int32)
        counts = np.zeros(batch, dtype=np.int64)
        for r, t in enumerate(group):
            m, s = frags.window(t.chrom, t.win_start, t.win_start + width)
            need = len(m) + width // 255 + 1
            if need > frag_cap:
                raise ValueError(
                    f"window at {t.chrom}:{t.win_start} needs {need} "
                    f"entries > frag_cap {frag_cap}; raise frag_cap"
                )
            mids[r, : len(m)] = m - t.win_start
            sizes[r, : len(s)] = s
            counts[r] = len(m)
        encode_delta_batch(mids, sizes, db, counts)
        yield DeltaBatch(db, group)


@dataclass
class DenseBatch:
    """Host-rasterized window batch (DESIGN.md §10; BASELINE north star
    "BAM fragment ingest -> pre-binned insertion/midpoint tensors").

    The [B, S, W] count matrix is built on host at memcpy-like speed and
    shipped as int16, leaving the device graph pure conv/matmul/
    elementwise with a single static shape."""

    mats: np.ndarray  # [B, S, W] int16 counts, S = upper-lower (full range)
    meta: List[TileMeta]


def rasterize_host(
    mids: np.ndarray, sizes: np.ndarray, lower: int, upper: int, width: int
) -> np.ndarray:
    """One window: (mid, size) lists -> [S, W] int16 (np.bincount, C speed)."""
    S = upper - lower
    keep = (mids >= 0) & (mids < width) & (sizes >= lower) & (sizes < upper)
    idx = (sizes[keep].astype(np.int64) - lower) * width + mids[keep]
    flat = np.bincount(idx, minlength=S * width)
    return flat.reshape(S, width).astype(np.int16)


@dataclass
class PoolBatch:
    """Wire-v7 upload (round-4 VERDICT item 4): fragments live in a
    chunk-resident device pool uploaded ONCE per group; each window ships
    only a 12-byte (rec_start, rec_count, base) table row pointing into
    it. Kills the per-batch fragment re-upload (405 KB/batch at B=128
    under wire v6), the halo duplication between overlapping windows of a
    chunk, AND the per-batch host delta encode."""

    pool: np.ndarray  # [cap//2 + cap] uint8 (nibble plane + size plane)
    pool_id: int  # changes when a new pool must be uploaded
    emax: int  # static per-run gather width (bucketed max records/window)
    table: np.ndarray  # [B, 3] int32
    meta: Sequence[TileMeta]


def _encode_chunk_stream12(m_abs: np.ndarray, s: np.ndarray, lo: int):
    """One chunk's 12-bit fragment records (wire-v6 semantics: fragment
    record advances by its nibble 0..14; skip record (size byte 0)
    advances nibble*15, so u = gap//15 units split into ceil(u/15) skips).
    Returns (rec_nib uint8[T], rec_sz uint8[T], frag_record_pos int64[n],
    pos_before int64[T] = absolute position before each record)."""
    n = len(m_abs)
    d = np.diff(m_abs, prepend=np.int64(lo)).astype(np.int64)
    u = d // 15
    frag_d = (d - u * 15).astype(np.uint8)  # 0..14
    k = (u + 14) // 15  # skip records per fragment
    total = int(n + k.sum())
    rec_nib = np.full(total, 15, np.uint8)  # skips default to 15 units
    rec_sz = np.zeros(total, np.uint8)
    frag_pos = (np.arange(n) + np.cumsum(k)).astype(np.int64)
    rec_nib[frag_pos] = frag_d
    rec_sz[frag_pos] = np.minimum(s, 255).astype(np.uint8)
    has = k > 0
    r = (u - 15 * (k - 1)).astype(np.uint8)  # last skip: 1..15 units
    rec_nib[frag_pos[has] - 1] = r[has]
    adv = np.where(rec_sz == 0, rec_nib.astype(np.int64) * 15, rec_nib)
    pos_before = lo + np.cumsum(adv) - adv
    return rec_nib, rec_sz, frag_pos, pos_before


def make_pool_batches(
    frags: BamFragments,
    tiles: Sequence[TileMeta],
    width: int,
    batch: int,
    budget: int = 1 << 18,
) -> Iterator[PoolBatch]:
    """Yields PoolBatch groups: whole chunks are packed into record pools
    of ~``budget`` records (one pow2 pool capacity for the whole run —
    compile-once, like the frag_cap bucket); batches within a group share
    its pool array, so the dispatcher uploads each pool exactly once.
    The last batch of a group may be partially filled (padding rows have
    rec_count 0)."""
    # chunk runs (tiles are emitted chunk-contiguous by tile_chunks)
    runs: List[Tuple[int, int]] = []
    for i, t in enumerate(tiles):
        if runs and tiles[runs[-1][0]].chunk_id == t.chunk_id:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))

    def chunk_entries(a: int, b: int, pool_off: int):
        """Stream + per-tile table rows for tiles[a:b] (one chunk).
        ``pool_off`` must be even (nibble-byte alignment); streams are
        padded to even length to keep it so."""
        ts = tiles[a:b]
        lo = min(t.win_start for t in ts)
        hi = max(t.win_start for t in ts) + width
        m_abs, s = frags.window(ts[0].chrom, lo, hi)
        m_abs = m_abs.astype(np.int64)
        rec_nib, rec_sz, frag_pos, pos_before = _encode_chunk_stream12(
            m_abs, s, lo
        )
        rows = np.zeros((len(ts), 3), np.int32)
        for r, t in enumerate(ts):
            j0 = int(np.searchsorted(m_abs, t.win_start))
            j1 = int(np.searchsorted(m_abs, t.win_start + width))
            if j1 <= j0:
                continue  # empty window: (0, 0, 0)
            rs = int(frag_pos[j0])
            rs -= rs & 1  # even-align; the extra record decodes left of
            # the window and is masked by the raster
            re_ = int(frag_pos[j1 - 1]) + 1
            base = int(pos_before[rs]) - t.win_start
            rows[r] = (pool_off + rs, re_ - rs, base)
        if len(rec_nib) & 1:  # pad stream to even record count
            rec_nib = np.append(rec_nib, np.uint8(0))
            rec_sz = np.append(rec_sz, np.uint8(0))
        return rec_nib, rec_sz, rows

    # Phase 1: encode every chunk stream once (numpy, ~2 B/fragment of
    # host memory — trivial even at genome scale); exact emax from the
    # actual per-window record counts
    enc = []
    emax_raw = 1
    for a, b in runs:
        nib, sz, rows = chunk_entries(a, b, 0)
        if len(rows):
            emax_raw = max(emax_raw, int(rows[:, 1].max()))
        enc.append((a, b, nib, sz, rows))
    emax = _bucket(emax_raw)  # pow2 -> even (nibble-plane gather width)

    # Phase 2: group split on actual stream lengths; one pow2 capacity for
    # the whole run (compile-once). The largest single chunk stream may
    # exceed the budget and owns its group.
    max_len = 0
    cur = 0
    for _, _, nib, _, _ in enc:
        if cur and cur + len(nib) > budget:
            max_len = max(max_len, cur)
            cur = 0
        cur += len(nib)
    max_len = max(max_len, cur, 1)
    cap = _bucket(max_len, minimum=1024)

    pool_id = 0
    pos = 0
    nib_parts: List[np.ndarray] = []
    sz_parts: List[np.ndarray] = []
    rows_buf: List[np.ndarray] = []
    metas: List[TileMeta] = []

    def flush_group():
        nonlocal pool_id, pos, nib_parts, sz_parts, rows_buf, metas
        if not metas:
            return
        nib = np.zeros(cap, np.uint8)
        cat = np.concatenate(nib_parts)
        nib[: len(cat)] = cat
        sz = np.zeros(cap, np.uint8)
        cat = np.concatenate(sz_parts)
        sz[: len(cat)] = cat
        pool = np.concatenate(
            [(nib[0::2] | (nib[1::2] << 4)).astype(np.uint8), sz]
        )
        rows = np.concatenate(rows_buf)
        for i in range(0, len(metas), batch):
            table = np.zeros((batch, 3), np.int32)
            sub = rows[i : i + batch]
            table[: len(sub)] = sub
            yield PoolBatch(pool, pool_id, emax, table, metas[i : i + batch])
        pool_id += 1
        pos = 0
        nib_parts, sz_parts, rows_buf, metas = [], [], [], []

    for a, b, nib, sz, rows in enc:
        if metas and pos + len(nib) > budget:
            yield from flush_group()
        nonzero = rows[:, 1] > 0
        rows[nonzero, 0] += pos
        nib_parts.append(nib)
        sz_parts.append(sz)
        rows_buf.append(rows)
        metas.extend(tiles[a:b])
        pos += len(nib)
    yield from flush_group()


def tile_chunks(
    chunks: ChunkList, cfg: WindowParams, occ: OccParams, vmat: VMatParams
) -> List[TileMeta]:
    halo = cfg.halo(occ, vmat)
    tiles: List[TileMeta] = []
    for cid, chunk in enumerate(chunks):
        one = ChunkList([chunk]).tile(cfg.core)
        for _, cs, ce in one:
            tiles.append(TileMeta(cid, chunk.chrom, cs, ce, cs - halo))
    return tiles


def _bucket(n: int, minimum: int = 256) -> int:
    f = minimum
    while f < n:
        f *= 2
    return f


def max_window_frags(
    frags: BamFragments, tiles: Sequence[TileMeta], width: int
) -> int:
    """Max fragment count over all windows (two binary searches per tile)."""
    best = 1
    for t in tiles:
        m = frags.mids.get(t.chrom)
        if m is None:
            continue
        n = int(
            np.searchsorted(m, t.win_start + width) - np.searchsorted(m, t.win_start)
        )
        best = max(best, n)
    return best


def make_batches(
    frags: BamFragments,
    tiles: Sequence[TileMeta],
    width: int,
    batch: int,
    frag_cap: int | None = None,
) -> Iterator[WindowBatch]:
    """Yields fixed-[B, F] batches. F is ONE power-of-two bucket for the
    whole run (from the global max window count) so the device step
    compiles exactly once, instead of once per shape bucket."""
    if frag_cap is None:
        frag_cap = _bucket(max_window_frags(frags, tiles, width))
    for i in range(0, len(tiles), batch):
        group = list(tiles[i : i + batch])
        frag_lists: List[Tuple[np.ndarray, np.ndarray]] = []
        for t in group:
            m, s = frags.window(t.chrom, t.win_start, t.win_start + width)
            frag_lists.append((m - t.win_start, s))
        F = frag_cap
        B = batch
        mids = np.zeros((B, F), dtype=np.int32)
        sizes = np.zeros((B, F), dtype=np.int32)
        valid = np.zeros((B, F), dtype=bool)
        for r, (m, s) in enumerate(frag_lists):
            if len(m) > F:
                raise ValueError(
                    f"window at {group[r].chrom}:{group[r].win_start} has "
                    f"{len(m)} fragments > frag_cap {F}; raise frag_cap"
                )
            mids[r, : len(m)] = m
            sizes[r, : len(s)] = s
            valid[r, : len(m)] = True
        yield WindowBatch(mids, sizes, valid, group)


def make_packed_batches(
    frags: BamFragments,
    tiles: Sequence[TileMeta],
    width: int,
    batch: int,
    frag_cap: int | None = None,
) -> Iterator[PackedBatch]:
    """Fixed-[B, F] packed-word batches (see PackedBatch)."""
    if width >= 1 << 16:
        raise ValueError(f"window width {width} overflows the 16-bit mid field")
    if frag_cap is None:
        frag_cap = _bucket(max_window_frags(frags, tiles, width))
    for i in range(0, len(tiles), batch):
        group = list(tiles[i : i + batch])
        packed = np.zeros((batch, frag_cap), dtype=np.int32)
        for r, t in enumerate(group):
            m, s = frags.window(t.chrom, t.win_start, t.win_start + width)
            if len(m) > frag_cap:
                raise ValueError(
                    f"window at {t.chrom}:{t.win_start} has {len(m)} "
                    f"fragments > frag_cap {frag_cap}; raise frag_cap"
                )
            pack_fragments(m - t.win_start, s, packed, r)
        yield PackedBatch(packed, group)


def make_dense_batches(
    frags: BamFragments,
    tiles: Sequence[TileMeta],
    width: int,
    batch: int,
    lower: int,
    upper: int,
) -> Iterator[DenseBatch]:
    """Host-rasterized batches: fixed [B, S, W] int16 count tensors."""
    S = upper - lower
    for i in range(0, len(tiles), batch):
        group = list(tiles[i : i + batch])
        mats = np.zeros((batch, S, width), dtype=np.int16)
        for r, t in enumerate(group):
            m, s = frags.window(t.chrom, t.win_start, t.win_start + width)
            mats[r] = rasterize_host(m - t.win_start, s, lower, upper, width)
        yield DenseBatch(mats, group)


class ChunkAssembler:
    """Collects per-tile core slices back into per-chunk dense tracks.

    The reference keeps genome order with queue-fed writer processes
    (SURVEY.md §3.3 "ordered result collection"); here tiles arrive in
    deterministic order and chunk tracks complete when all their tiles
    have landed.
    """

    def __init__(self, chunks: ChunkList, track_names: Sequence[str]):
        self.chunks = chunks
        self.names = list(track_names)
        self.tracks: Dict[int, Dict[str, np.ndarray]] = {}
        self.remaining: Dict[int, int] = {}

    def expect(self, tiles: Sequence[TileMeta]) -> None:
        for t in tiles:
            self.remaining[t.chunk_id] = self.remaining.get(t.chunk_id, 0) + 1

    def add(
        self, t: TileMeta, values: Dict[str, np.ndarray], win_start_col: int
    ) -> Iterator[Tuple[int, Chunk, Dict[str, np.ndarray]]]:
        """values: full-width [W] arrays; win_start_col = column of
        t.core_start in the window. Yields (chunk_id, chunk, tracks) for
        chunks that completed."""
        chunk = self.chunks[t.chunk_id]
        if t.chunk_id not in self.tracks:
            self.tracks[t.chunk_id] = {
                n: np.zeros(len(chunk), dtype=np.float64) for n in self.names
            }
        off = t.core_start - chunk.start
        n_core = t.core_end - t.core_start
        for n in self.names:
            self.tracks[t.chunk_id][n][off : off + n_core] = values[n][
                win_start_col : win_start_col + n_core
            ]
        self.remaining[t.chunk_id] -= 1
        if self.remaining[t.chunk_id] == 0:
            yield t.chunk_id, chunk, self.tracks.pop(t.chunk_id)
            del self.remaining[t.chunk_id]
