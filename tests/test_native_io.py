"""Native C++ BAM scanner vs pure-Python scanner (golden equality)."""

import numpy as np
import pytest

from nucleoatac_jax.config import IngestParams
from nucleoatac_jax.io.bam_py import scan_bam_py
from nucleoatac_jax.io.bam_writer import write_bam


@pytest.fixture(scope="module")
def native():
    from nucleoatac_jax.io.native import build

    build("nucio")
    from nucleoatac_jax.io.native.binding import scan_bam_native

    return scan_bam_native


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(3)
    frags = []
    for rid in (0, 1):
        for _ in range(5000):
            left = int(rng.integers(100, 90_000))
            size = int(rng.integers(30, 400))
            frags.append((rid, left, size))
    path = str(d / "big.bam")
    write_bam(path, ["chr1", "chr2"], [100_000, 100_000], frags)
    return path


def test_native_matches_python(native, bam):
    p = IngestParams()
    names_n, lens_n, lefts_n, sizes_n = native(bam, p)
    names_p, lens_p, lefts_p, sizes_p = scan_bam_py(bam, p)
    assert names_n == names_p and lens_n == lens_p
    for c in names_n:
        np.testing.assert_array_equal(lefts_n[c], lefts_p[c])
        # same multiset of (left, size); stable order may differ within ties
        a = np.sort(np.stack([lefts_n[c], sizes_n[c]]), axis=1)
        b = np.sort(np.stack([lefts_p[c], sizes_p[c]]), axis=1)
        np.testing.assert_array_equal(
            np.sort(lefts_n[c] * 10_000 + sizes_n[c]),
            np.sort(lefts_p[c] * 10_000 + sizes_p[c]),
        )


def test_native_filters(native, bam):
    strict = IngestParams(max_size=100)
    _, _, _, sizes = native(bam, strict)
    for c in sizes:
        if len(sizes[c]):
            assert sizes[c].max() <= 100


def test_native_not_atac(native, bam):
    raw = IngestParams(atac=False)
    adj = IngestParams(atac=True)
    _, _, lefts_r, sizes_r = native(bam, raw)
    _, _, lefts_a, sizes_a = native(bam, adj)
    # every adjusted fragment = raw fragment shifted +4, size -9
    c = "chr1"
    raw_set = set(zip(lefts_r[c].tolist(), sizes_r[c].tolist()))
    for l, s in zip(lefts_a[c].tolist(), sizes_a[c].tolist()):
        assert (l - 4, s + 9) in raw_set


def test_native_missing_file(native):
    with pytest.raises(OSError):
        native("/nonexistent/foo.bam", IngestParams())
