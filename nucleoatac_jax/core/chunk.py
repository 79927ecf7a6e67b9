"""Genomic intervals and interval lists.

Analogue of reference:pyatac/chunk.py :: Chunk, ChunkList
(SURVEY.md §3.1): 0-based half-open intervals, BED parsing, overlap
merging, chromosome validation, and tiling into fixed-size window cores
for batched device processing (the reference instead split for a
multiprocessing pool; we split into regular [core]+halo windows,
DESIGN.md §10).
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple


@dataclass(order=True)
class Chunk:
    chrom: str
    start: int
    end: int
    name: str = field(default=".", compare=False)
    strand: str = field(default="+", compare=False)

    def __post_init__(self) -> None:
        if self.end < self.start:
            raise ValueError(f"Chunk end < start: {self}")

    def __len__(self) -> int:
        return self.end - self.start

    def center(self) -> int:
        return (self.start + self.end) // 2

    def overlaps(self, other: "Chunk") -> bool:
        return (
            self.chrom == other.chrom
            and self.start < other.end
            and other.start < self.end
        )

    def expand(self, pad: int, chrom_len: Optional[int] = None) -> "Chunk":
        start = max(0, self.start - pad)
        end = self.end + pad
        if chrom_len is not None:
            end = min(end, chrom_len)
        return Chunk(self.chrom, start, end, self.name, self.strand)


class ChunkList:
    """Ordered list of chunks, optionally merged."""

    def __init__(self, chunks: Iterable[Chunk] = ()) -> None:
        self.chunks: List[Chunk] = list(chunks)

    def __iter__(self) -> Iterator[Chunk]:
        return iter(self.chunks)

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, i: int) -> Chunk:
        return self.chunks[i]

    @classmethod
    def read(
        cls,
        bedfile: str,
        chromDict: Optional[Mapping[str, int]] = None,
        min_offset: int = 0,
    ) -> "ChunkList":
        """Parse a BED(.gz) file. With ``chromDict`` (chrom -> length),
        clips to chromosome bounds and drops unknown chromosomes
        (reference ChunkList.read + checkChroms combined)."""
        opener = gzip.open if bedfile.endswith(".gz") else open
        out: List[Chunk] = []
        with opener(bedfile, "rt") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                fields = line.split("\t")
                if len(fields) < 3:
                    fields = line.split()
                chrom, start, end = fields[0], int(fields[1]), int(fields[2])
                name = fields[3] if len(fields) > 3 else "."
                strand = fields[5] if len(fields) > 5 else "+"
                if chromDict is not None:
                    if chrom not in chromDict:
                        continue
                    start = max(min_offset, start)
                    end = min(chromDict[chrom], end)
                    if end <= start:
                        continue
                out.append(Chunk(chrom, start, end, name, strand))
        return cls(out)

    def sort(self, chrom_order: Optional[Sequence[str]] = None) -> "ChunkList":
        if chrom_order is not None:
            rank = {c: i for i, c in enumerate(chrom_order)}
            self.chunks.sort(key=lambda c: (rank.get(c.chrom, 1 << 30), c.start, c.end))
        else:
            self.chunks.sort(key=lambda c: (c.chrom, c.start, c.end))
        return self

    def merge(self, gap: int = 0) -> "ChunkList":
        """Merge overlapping/adjacent (within ``gap``) chunks; assumes or
        establishes sorted order."""
        self.sort()
        merged: List[Chunk] = []
        for c in self.chunks:
            if merged and merged[-1].chrom == c.chrom and c.start <= merged[-1].end + gap:
                merged[-1] = Chunk(
                    merged[-1].chrom, merged[-1].start, max(merged[-1].end, c.end)
                )
            else:
                merged.append(Chunk(c.chrom, c.start, c.end))
        return ChunkList(merged)

    def checkChroms(self, known: Mapping[str, int]) -> "ChunkList":
        missing = sorted({c.chrom for c in self.chunks if c.chrom not in known})
        if missing:
            raise ValueError(f"Chromosomes absent from BAM/FASTA header: {missing}")
        return self

    def total_bp(self) -> int:
        return sum(len(c) for c in self.chunks)

    def tile(self, core: int) -> List[Tuple[Chunk, int, int]]:
        """Tile each chunk into window cores of exactly ``core`` bp.

        Returns [(parent_chunk, core_start, core_end)] where each core is
        ``core`` bp; the last tile of a chunk is right-aligned to the chunk
        end so tiles may overlap but never exceed the chunk. Chunks shorter
        than ``core`` yield one tile whose core covers the whole chunk
        (core_end - core_start == len(chunk) < core); callers mask the
        remainder.
        """
        tiles: List[Tuple[Chunk, int, int]] = []
        for c in self.chunks:
            if len(c) <= core:
                tiles.append((c, c.start, c.end))
                continue
            s = c.start
            while s + core < c.end:
                tiles.append((c, s, s + core))
                s += core
            tiles.append((c, c.end - core, c.end))
        return tiles


def read_chrom_sizes_from_fai(fai_path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    with open(fai_path) as fh:
        for line in fh:
            f = line.split("\t")
            if len(f) >= 2:
                out[f[0]] = int(f[1])
    return out
