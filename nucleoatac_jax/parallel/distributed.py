"""Multi-host orchestration: jax.distributed init + per-host work split.

Replaces the reference's single-host multiprocessing model (SURVEY.md
§3.3): on a cluster each host process scans the (shared) BAM, takes a
deterministic contiguous slice of the window tiles, runs the sharded
device steps over its local devices, and host 0 concatenates per-host
partial outputs into the genome-ordered files (hosts write
`<out>.part<k>` shards; `merge_host_shards` concatenates — bedgraph/BED
rows are disjoint and ordered because the tile split is contiguous in
genome order).
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import jax


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_rank: int | None = None,
) -> Tuple[int, int]:
    """Initialize jax.distributed from args or env
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID,
    LOCAL_RANK). Returns (process_id, num_processes); (0, 1) when not
    distributed.

    Several processes on one host need one card each: a JAX process
    reserves most of the memory of every card it opens, so a second
    process on the same card fails. Where the launcher gives a local
    rank (``local_rank`` or LOCAL_RANK), this process opens only the card
    of that index; otherwise give each process its own card with
    CUDA_VISIBLE_DEVICES before it starts."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return 0, 1
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    if local_rank is None and os.environ.get("LOCAL_RANK"):
        local_rank = int(os.environ["LOCAL_RANK"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=None if local_rank is None else [local_rank],
    )
    return process_id, num_processes


def host_tile_slice(tiles: Sequence, process_id: int, num_processes: int) -> List:
    """Contiguous (genome-ordered) slice of tiles for this host, balanced
    by count."""
    n = len(tiles)
    lo = (n * process_id) // num_processes
    hi = (n * (process_id + 1)) // num_processes
    return list(tiles[lo:hi])


def merge_host_shards(out_prefix: str, suffix: str, num_processes: int) -> None:
    """Concatenate per-host BGZF shards `<prefix>.part<k><suffix>` into
    `<prefix><suffix>` (BGZF members concatenate losslessly; the EOF
    blocks of intermediate shards are legal empty members). Streams in
    1 MB blocks — shards are genome-scale."""
    dst = f"{out_prefix}{suffix}"
    with open(dst, "wb") as out:
        for k in range(num_processes):
            part = f"{out_prefix}.part{k}{suffix}"
            with open(part, "rb") as fh:
                while True:
                    block = fh.read(1 << 20)
                    if not block:
                        break
                    out.write(block)
            os.remove(part)
            tbi = part + ".tbi"
            if os.path.exists(tbi):
                os.remove(tbi)
    rebuild_tabix(dst)


def rebuild_tabix(path: str) -> None:
    """Re-index a merged BGZF text file (concatenation invalidates the
    per-shard virtual offsets, so the file is re-written through a
    TabixWriter — which also makes the merged .gz byte-identical to a
    single-host run's, since BGZF block boundaries depend only on
    content). Round 5: block-parse with the C++ bedgraph/BED parser and
    write via add_many_blob instead of a per-line Python loop — the old
    path was ~190 s of a 270 s config-5 finalize (the two signal
    bedgraphs are ~10M lines each at 10k peaks). Constant memory."""
    import gzip

    import numpy as np

    from nucleoatac_jax.io.tabix import TabixWriter

    tmp = path + ".reindex"
    with TabixWriter(tmp) as w, gzip.open(path, "rb") as fh:
        carry = b""
        while True:
            data = fh.read(4 << 20)
            if not data and not carry.strip():
                break
            if not data and not carry.endswith(b"\n"):
                carry += b"\n"
            buf = carry + data
            chroms, seg, starts, ends, _, consumed = _parse_lines(buf)
            carry = buf[consumed:]
            if len(starts) == 0:
                if not data:
                    break
                continue
            block = buf[:consumed]
            # line-start offsets for blob slicing
            nl = np.flatnonzero(
                np.frombuffer(block, np.uint8) == 0x0A
            )
            offs = np.concatenate(([0], nl + 1))
            for k, chrom in enumerate(chroms):
                a, b = int(seg[k]), int(seg[k + 1])
                w.add_many_blob(
                    chrom, starts[a:b], ends[a:b], block, offs[a : b + 1]
                )
            if not data:
                break
    os.replace(tmp, path)
    os.replace(tmp + ".tbi", path + ".tbi")


def _parse_lines(buf: bytes):
    """Block line parse: C++ fast path, python fallback (same interface
    as models/standalone._BedgraphBlockStream._parse)."""
    try:
        from nucleoatac_jax.io.native.binding import (
            HAS_PARSE_BEDGRAPH,
            parse_bedgraph_native,
        )
    except (OSError, ImportError):
        HAS_PARSE_BEDGRAPH = False
    if HAS_PARSE_BEDGRAPH:
        return parse_bedgraph_native(buf)
    import numpy as np

    end = buf.rfind(b"\n") + 1
    chroms: list[str] = []
    seg: list[int] = []
    starts, ends = [], []
    for ln in buf[:end].splitlines():
        f = ln.split(b"\t")
        c = f[0].decode()
        if not chroms or c != chroms[-1]:
            chroms.append(c)
            seg.append(len(starts))
        starts.append(int(f[1]))
        ends.append(int(f[2]))
    return (
        chroms, np.array(seg + [len(starts)], np.int64),
        np.array(starts, np.int64), np.array(ends, np.int64), None, end,
    )
