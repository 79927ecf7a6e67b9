"""Packed fragment wire format + on-device PWM bias (ops/pwmseq.py).

Packed `(size<<16)|mid` words and uint8 sequence codes are the production
host->device transfer; these tests pin them to the separate-array path
and the host float64 PWM oracle (core/pwm.py :: PWM.bias_track)."""
import jax
import jax.numpy as jnp
import numpy as np

from nucleoatac_jax.core.pwm import BASE_INDEX, PWM
from nucleoatac_jax.models.data import (
    encode_delta_fragments,
    pack_fragments,
    pack_nibble_codes,
)
from nucleoatac_jax.ops import (
    rasterize_batch,
    rasterize_delta_batch,
    rasterize_packed_batch,
    unpack_delta_fragments,
    unpack_fragments,
)
from nucleoatac_jax.ops.pwmseq import pwm_bias_batch, unpack_nibble_codes


def test_pack_roundtrip(rng):
    B, F = 4, 200
    mids = rng.integers(0, 60000, size=(B, F)).astype(np.int32)
    sizes = rng.integers(1, 300, size=(B, F)).astype(np.int32)
    packed = np.zeros((B, F), np.int32)
    n_valid = [F, 150, 0, 37]
    for b in range(B):
        pack_fragments(mids[b, : n_valid[b]], sizes[b, : n_valid[b]], packed, b)
    m, s, v = map(np.asarray, unpack_fragments(jnp.asarray(packed)))
    for b in range(B):
        n = n_valid[b]
        assert (v[b, :n]).all() and not v[b, n:].any()
        np.testing.assert_array_equal(m[b, :n], mids[b, :n])
        np.testing.assert_array_equal(s[b, :n], sizes[b, :n])


def test_rasterize_packed_matches_frags(rng):
    B, F, W, LOWER, UPPER = 3, 500, 512, 0, 251
    mids = rng.integers(0, W, size=(B, F)).astype(np.int32)
    sizes = rng.integers(1, 300, size=(B, F)).astype(np.int32)
    n_valid = [F, 123, 0]
    packed = np.zeros((B, F), np.int32)
    valid = np.zeros((B, F), bool)
    for b in range(B):
        pack_fragments(mids[b, : n_valid[b]], sizes[b, : n_valid[b]], packed, b)
        valid[b, : n_valid[b]] = True
    a = np.asarray(
        rasterize_batch(
            jnp.asarray(mids), jnp.asarray(sizes), jnp.asarray(valid),
            LOWER, UPPER, W,
        )
    )
    d = np.asarray(rasterize_packed_batch(jnp.asarray(packed), LOWER, UPPER, W))
    np.testing.assert_array_equal(a, d)


def test_delta_roundtrip(rng):
    """Delta encode -> device decode recovers sorted (mid, size) lists,
    including gaps > 255 bp (skip entries) and empty windows."""
    B, F, W = 4, 600, 1500
    counts = [400, 3, 0, 120]
    db = np.zeros((B, F, 2), np.uint8)
    want = []
    for b in range(B):
        mids = np.sort(rng.integers(0, W, size=counts[b])).astype(np.int64)
        sizes = rng.integers(1, 251, size=counts[b]).astype(np.int64)
        n_ent = encode_delta_fragments(mids, sizes, db, b)
        assert n_ent <= F
        want.append((mids, sizes))
    m, s, v = map(np.asarray, unpack_delta_fragments(jnp.asarray(db)))
    for b in range(B):
        mids, sizes = want[b]
        np.testing.assert_array_equal(m[b][v[b]], mids)
        np.testing.assert_array_equal(s[b][v[b]], sizes)


def test_rasterize_delta_matches_frags(rng):
    B, F, W, LOWER, UPPER = 3, 600, 1024, 0, 251
    db = np.zeros((B, F, 2), np.uint8)
    mats = []
    for b in range(B):
        n = [500, 17, 0][b]
        mids = np.sort(rng.integers(0, W, size=n)).astype(np.int64)
        sizes = rng.integers(1, 320, size=n).astype(np.int64)  # some > upper
        encode_delta_fragments(mids, sizes, db, b)
        valid = np.ones((1, n), bool)
        mats.append(
            np.asarray(
                rasterize_batch(
                    jnp.asarray(mids[None].astype(np.int32)),
                    jnp.asarray(np.minimum(sizes, 255)[None].astype(np.int32)),
                    jnp.asarray(valid), LOWER, UPPER, W,
                )
            )[0]
        )
    d = np.asarray(rasterize_delta_batch(jnp.asarray(db), LOWER, UPPER, W))
    np.testing.assert_array_equal(d, np.stack(mats))


def test_nibble_codes_roundtrip(rng):
    for wp in (401, 400):  # odd + even widths
        codes = rng.integers(0, 5, size=(3, wp)).astype(np.uint8)
        packed = pack_nibble_codes(codes)
        assert packed.shape == (3, (wp + 1) // 2)
        out = np.asarray(unpack_nibble_codes(jnp.asarray(packed), wp))
        np.testing.assert_array_equal(out, codes)


def test_pwm_bias_matches_host_oracle(rng):
    pwm = PWM.default()
    W = 400
    wp = W + pwm.length - 1
    seq = "".join(
        rng.choice(list("ACGTN"), size=wp, p=[0.24, 0.24, 0.24, 0.24, 0.04])
    )
    codes = BASE_INDEX[np.frombuffer(seq.encode(), np.uint8)]
    codes = np.where(codes < 0, 4, codes).astype(np.uint8)
    host = pwm.bias_track(seq)[pwm.up : pwm.up + W]
    dev = np.asarray(
        pwm_bias_batch(
            jnp.asarray(codes[None]), jnp.asarray(pwm.log_ratio(), jnp.float32)
        )
    )[0]
    np.testing.assert_allclose(dev, host, atol=2e-6)


def test_pwm_bias_out_of_genome_edges():
    """Codes 4 (N / out-of-genome) contribute zero, matching the host
    oracle's partial-context behavior at sequence boundaries."""
    pwm = PWM.default()
    W = 50
    wp = W + pwm.length - 1
    codes = np.full(wp, 4, np.uint8)
    codes[pwm.up + 10 : pwm.up + 40] = 2  # a G run mid-window
    dev = np.asarray(
        pwm_bias_batch(
            jnp.asarray(codes[None]), jnp.asarray(pwm.log_ratio(), jnp.float32)
        )
    )[0]
    seq = "".join("G" if 10 <= i - pwm.up < 40 else "N" for i in range(wp))
    host = pwm.bias_track(seq)[pwm.up : pwm.up + W]
    np.testing.assert_allclose(dev, host, atol=2e-6)


def test_engine_seq_path_matches_host_bias_path(rng):
    """full_step_packed_seq == full_step_packed(host-computed bias) at f32."""
    from __graft_entry__ import _tiny_engine

    cfg, _ = _tiny_engine()
    from nucleoatac_jax.models.engine import DeviceEngine
    from nucleoatac_jax.core.fragmentsizes import FragmentSizes
    from nucleoatac_jax.core.mixture import FragmentMixDistribution

    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (
        2e4 * np.exp(-s / 45.0) + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)
    ).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    pwm = PWM.default()
    eng = DeviceEngine(cfg, mix, fs, pwm=pwm)

    B, F, W = 2, 256, eng.width
    mids = rng.integers(0, W, size=(B, F)).astype(np.int32)
    sizes = rng.integers(20, 250, size=(B, F)).astype(np.int32)
    packed = np.zeros((B, F), np.int32)
    for b in range(B):
        pack_fragments(mids[b], sizes[b], packed, b)
    wp = eng.seq_codes_width()
    codes = rng.integers(0, 4, size=(B, wp)).astype(np.uint8)
    # host bias from the same codes
    logb = np.zeros((B, W), np.float32)
    for b in range(B):
        seq = "".join("ACGT"[c] for c in codes[b])
        logb[b] = pwm.bias_track(seq)[pwm.up : pwm.up + W].astype(np.float32)

    o1 = eng.full_step_packed(jnp.asarray(packed), jnp.asarray(logb))
    o2 = eng.full_step_packed_seq(jnp.asarray(packed), jnp.asarray(codes))
    for a, b in zip(jax.tree.leaves(o1), jax.tree.leaves(o2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)


def _tiny(rng):
    from __graft_entry__ import _tiny_engine

    cfg, eng = _tiny_engine()
    B, F = 2, 256
    W = eng.width
    mids = np.sort(rng.integers(0, W, size=(B, F)), axis=1).astype(np.int64)
    sizes = rng.integers(20, 250, size=(B, F)).astype(np.int64)
    db = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
    for b in range(B):
        encode_delta_fragments(mids[b], sizes[b], db, b)
    wp = eng.seq_codes_width()
    codes = rng.integers(0, 4, size=(B, wp)).astype(np.uint8)
    return cfg, eng, db, codes


def test_occ_compact_matches_full_tracks(rng):
    """uint8 grid-index download decodes to the same occ/lower/upper as
    the six-track OccTracks path."""
    cfg, eng, db, _ = _tiny(rng)
    full = eng.occ_step_delta(jnp.asarray(db))
    comp = np.asarray(eng.occ_step_delta_c(jnp.asarray(db)), np.int64)
    G = cfg.occ.grid_size
    grid = np.linspace(0.0, 1.0, G)
    np.testing.assert_allclose(grid[comp[:, 0]], np.asarray(full.occ), atol=1e-6)
    np.testing.assert_allclose(grid[comp[:, 1]], np.asarray(full.lower), atol=1e-6)
    np.testing.assert_allclose(grid[comp[:, 2]], np.asarray(full.upper), atol=1e-6)
    # certified flag agrees with the margin tracks (strict > on device)
    tol = cfg.occ.exact_tol
    mg = np.asarray(full.margin)
    cm = np.asarray(full.ci_margin)
    want = ((mg > tol) & (cm > tol)) | (np.asarray(full.n) <= 0)
    np.testing.assert_array_equal(comp[:, 3].astype(bool), want)


def test_nuc_compact_matches_tracks(rng):
    """Stacked [B, 5, W] download equals the five NucTracks arrays."""
    cfg, eng, db, codes = _tiny(rng)
    nib = jnp.asarray(pack_nibble_codes(codes))
    full = eng.nuc_step_delta_seq(jnp.asarray(db), nib)
    comp = np.asarray(eng.nuc_step_delta_seq_c(jnp.asarray(db), nib))
    for i, name in enumerate(["norm", "norm_smooth", "signal", "lr", "fuzz"]):
        np.testing.assert_allclose(
            comp[:, i], np.asarray(getattr(full, name)), atol=1e-5,
            err_msg=name,
        )


def test_delta_guards():
    """ADVICE round-1 fixes: wire-format preconditions are enforced."""
    import dataclasses

    import pytest

    from nucleoatac_jax.config import (
        OccParams,
        RunConfig,
        SizesParams,
        WindowParams,
    )

    # pool/delta + sizes.upper > 255 would miscount saturated fragments
    with pytest.raises(ValueError, match="wire format"):
        RunConfig(sizes=SizesParams(upper=300))
    # packed is fine at the same upper
    RunConfig(
        sizes=SizesParams(upper=300),
        window=WindowParams(transfer="packed"),
    )
    # grid indices ship as uint8
    with pytest.raises(ValueError, match="grid"):
        RunConfig(occ=OccParams(grid_size=300))
    # CLI falls back to packed instead of raising
    from nucleoatac_jax.cli.nucleoatac import build_config, nucleoatac_parser

    args = nucleoatac_parser().parse_args(
        ["occ", "--bam", "x", "--bed", "y", "--out", "z", "--upper", "300"]
    )
    cfg = build_config(args)
    assert cfg.window.transfer == "packed" and cfg.sizes.upper == 300

    # unsorted mids are rejected by the delta encoder
    out = np.zeros((1, 16, 2), np.uint8)
    with pytest.raises(ValueError, match="sorted"):
        encode_delta_fragments(
            np.array([10, 5]), np.array([100, 100]), out, 0
        )


def test_occ_packed3_matches_full_tracks(rng):
    """Wire v2: uint8 [B, 3, core] core-only download decodes to the same
    occ/lower/upper/cert as the full-width OccTracks path."""
    cfg, eng, db, _ = _tiny(rng)
    full = eng.occ_step_delta(jnp.asarray(db))
    comp = np.asarray(eng.occ_step_delta_c3(jnp.asarray(db)), np.int64)
    assert comp.shape == (db.shape[0], 3, eng.core)
    lo, hi = eng.core_lo, eng.core_lo + eng.core
    G = cfg.occ.grid_size
    grid = np.linspace(0.0, 1.0, G)
    idx = comp & 0x7F
    cert = (comp[:, 0] >> 7).astype(bool)
    np.testing.assert_allclose(
        grid[idx[:, 0]], np.asarray(full.occ)[:, lo:hi], atol=1e-6
    )
    np.testing.assert_allclose(
        grid[idx[:, 1]], np.asarray(full.lower)[:, lo:hi], atol=1e-6
    )
    np.testing.assert_allclose(
        grid[idx[:, 2]], np.asarray(full.upper)[:, lo:hi], atol=1e-6
    )
    tol = cfg.occ.exact_tol
    mg = np.asarray(full.margin)[:, lo:hi]
    cm = np.asarray(full.ci_margin)[:, lo:hi]
    want = ((mg > tol) & (cm > tol)) | (np.asarray(full.n)[:, lo:hi] <= 0)
    np.testing.assert_array_equal(cert, want)


def test_nuc_c2_matches_tracks(rng):
    """Wire v2: f32 [B, 2, core] equals the norm/norm_smooth NucTracks."""
    cfg, eng, db, codes = _tiny(rng)
    nib = jnp.asarray(pack_nibble_codes(codes))
    full = eng.nuc_step_delta_seq(jnp.asarray(db), nib)
    comp = np.asarray(eng.nuc_step_delta_seq_c2(jnp.asarray(db), nib))
    assert comp.shape == (db.shape[0], 2, eng.core)
    lo, hi = eng.core_lo, eng.core_lo + eng.core
    np.testing.assert_allclose(
        comp[:, 0], np.asarray(full.norm)[:, lo:hi], atol=1e-6
    )
    np.testing.assert_allclose(
        comp[:, 1], np.asarray(full.norm_smooth)[:, lo:hi], atol=1e-6
    )


def test_occ_packed2_matches_packed3_where_certified(rng):
    """Wire v8: uint8 [B, 2*core + ceil(core/4)] (CI bounds as 5-bit
    deltas — 4-bit low nibbles + a packed hi-bit plane) decodes to the
    same occ/lower/upper as wire v2 at every CERTIFIED position, and
    every position v2 certified that v8 does not is exactly a delta
    overflow (>31 grid steps) or an empty window (the two documented
    fallback cases, both routed through the f64 refinisher)."""
    cfg, eng, db, _ = _tiny(rng)
    v2 = np.asarray(eng.occ_step_delta_c3(jnp.asarray(db)), np.int64)
    v8 = np.asarray(eng.occ_step_delta_p2(jnp.asarray(db)))
    assert v8.shape == (db.shape[0], 2 * eng.core + (eng.core + 3) // 4)
    idx8, cert8 = eng.decode_occ2(v8)
    idx2 = v2 & 0x7F
    cert2 = (v2[:, 0] >> 7).astype(bool)
    # wherever v8 certifies, all three indices agree with v2
    sel = np.broadcast_to(cert8[:, None], idx8.shape)
    np.testing.assert_array_equal(idx8[sel], idx2[sel])
    # v8 certifies a subset of v2 (extra fallbacks only)
    assert not np.any(cert8 & ~cert2)
    extra = cert2 & ~cert8
    lo_d = idx2[:, 0] - idx2[:, 1]
    up_d = idx2[:, 2] - idx2[:, 0]
    full = eng.occ_step_delta(jnp.asarray(db))
    empty = np.asarray(full.n)[:, eng.core_lo : eng.core_lo + eng.core] <= 0
    assert np.all((lo_d > 31) | (up_d > 31) | empty | ~extra)


def test_u24_norm_roundtrip(rng):
    """Wire v4 nuc: u24-truncated norm decodes within 2^-16 relative of
    the f32 track (round-to-nearest on the dropped byte)."""
    cfg, eng, db, codes = _tiny(rng)
    nib = jnp.asarray(pack_nibble_codes(codes))
    f32 = np.asarray(eng.nuc_step_delta_seq_m(jnp.asarray(db), nib))
    u24 = np.asarray(eng.nuc_step_delta_seq_m24(jnp.asarray(db), nib))
    assert u24.shape == f32.shape + (3,)
    dec = eng.f32_from_u24(u24)
    np.testing.assert_allclose(dec, f32, rtol=2 ** -16, atol=1e-30)
    # exactness of the codec itself on crafted values incl. negatives
    vals = np.array(
        [[0.0, -0.0, 1.5, -3.25, 1e-20, 12345.678, -9.999e4]], np.float32
    )
    dev = np.asarray(jax.jit(eng._u24_impl)(jnp.asarray(vals)))
    dec2 = eng.f32_from_u24(dev)
    np.testing.assert_allclose(dec2, vals, rtol=2 ** -16)


def test_u16_norm_roundtrip(rng):
    """Wire v5 nuc: u16 affine-quantized norm decodes within the
    advertised error bound (scale/2 per window) of the f32 track, and
    the reported qstep bounds the actual error."""
    cfg, eng, db, codes = _tiny(rng)
    nib = jnp.asarray(pack_nibble_codes(codes))
    f32 = np.asarray(eng.nuc_step_delta_seq_m(jnp.asarray(db), nib))
    u16 = np.asarray(eng.nuc_step_delta_seq_m16(jnp.asarray(db), nib))
    assert u16.shape == (f32.shape[0], 2 * f32.shape[1] + 8)
    dec, qstep = eng.f32_from_u16(u16)
    assert dec.shape == f32.shape
    err = np.abs(dec - f32)
    # per-row error within the per-row quantization step (qstep = scale
    # is 2x the rounding bound scale/2; tiny slack for f32 arithmetic)
    assert np.all(err <= qstep[:, None] * (0.5 + 1e-3) + 1e-7)
    # constant row quantizes losslessly (scale == 0 path)
    vals = np.array([[2.5] * 16, [-1.0] * 8 + [3.0] * 8], np.float32)
    dev = np.asarray(jax.jit(eng._u16_impl)(jnp.asarray(vals)))
    dec2, q2 = eng.f32_from_u16(dev)
    np.testing.assert_array_equal(dec2[0], vals[0])
    assert q2[0] == 0.0
    np.testing.assert_allclose(dec2[1], vals[1], atol=q2[1])


def test_run_step_delta_unpack_matches_stages(rng):
    """The fused v5 packed buffer round-trips to exactly the packed2 occ
    decode + u16 norm decode of the separate stage outputs."""
    cfg, eng, db, codes = _tiny(rng)
    nib = jnp.asarray(pack_nibble_codes(codes))
    buf = np.asarray(eng.run_step_delta(jnp.asarray(db), nib))
    idx, cert, norm, qstep = eng.unpack_run(buf)
    idx_s, cert_s = eng.decode_occ2(
        np.asarray(eng.occ_step_delta_p2(jnp.asarray(db)))
    )
    norm_s, qstep_s = eng.f32_from_u16(
        np.asarray(eng.nuc_step_delta_seq_m16(jnp.asarray(db), nib))
    )
    np.testing.assert_array_equal(idx, idx_s)
    np.testing.assert_array_equal(cert, cert_s)
    np.testing.assert_array_equal(norm, norm_s)
    np.testing.assert_array_equal(qstep, qstep_s)


def _tiny12(rng):
    """Delta + delta12 encodings of the same fragments."""
    from nucleoatac_jax.models.data import (
        delta12_entry_capacity,
        encode_delta12_batch,
        encode_delta_batch,
    )

    cfg, eng, db, codes = _tiny(rng)
    # decode db back to (mids, sizes) is awkward; regenerate deterministic
    from __graft_entry__ import _tiny_engine

    B, F = 2, 256
    W = eng.width
    mids = np.sort(rng.integers(0, W, size=(B, F)), axis=1).astype(np.int64)
    sizes = rng.integers(20, 250, size=(B, F)).astype(np.int64)
    db = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
    encode_delta_batch(mids, sizes, db)
    E = delta12_entry_capacity(F, W)
    buf = np.zeros((B, E // 2 + E), np.uint8)
    encode_delta12_batch(mids, sizes, buf)
    return cfg, eng, db, buf, codes


def test_delta12_raster_matches_delta(rng):
    """Wire-v6 upload decodes to the SAME count matrices as the 2-byte
    delta format (same fragments, byte-identical downstream)."""
    cfg, eng, db, buf, _ = _tiny12(rng)
    a = np.asarray(eng._raster_delta(jnp.asarray(db)))
    b = np.asarray(eng._raster_delta12(jnp.asarray(buf)))
    np.testing.assert_array_equal(a, b)


def test_delta12_run_step_matches_delta(rng):
    """run_step_delta12 == run_step_delta bytes (identical programs after
    rasterization)."""
    cfg, eng, db, buf, codes = _tiny12(rng)
    nib = jnp.asarray(pack_nibble_codes(codes))
    a = np.asarray(eng.run_step_delta(jnp.asarray(db), nib))
    b = np.asarray(eng.run_step_delta12(jnp.asarray(buf), nib))
    np.testing.assert_array_equal(a, b)


def test_delta12_sparse_extreme_gaps(rng):
    """Sparse windows with multi-hundred-bp gaps stay within the declared
    record capacity and decode exactly."""
    from nucleoatac_jax.models.data import (
        delta12_entry_capacity,
        encode_delta12_batch,
    )
    from nucleoatac_jax.ops.rasterize import unpack_delta12_fragments

    W = 1536
    mids = np.array([[0, 16, 31, 254, 255, 256, 1535]], np.int64)
    sizes = np.full((1, 7), 147, np.int64)
    E = delta12_entry_capacity(7, W)
    buf = np.zeros((1, E // 2 + E), np.uint8)
    encode_delta12_batch(mids, sizes, buf)
    m, s, v = (np.asarray(x) for x in
               unpack_delta12_fragments(jnp.asarray(buf), E))
    np.testing.assert_array_equal(m[0][v[0]], mids[0])
    np.testing.assert_array_equal(s[0][v[0]], sizes[0])


def test_pool_wire_bitwise_equals_delta12():
    """Wire v7 (chunk-resident pool + per-window table) must produce a
    BITWISE-identical run_step output buffer to the per-window delta12
    upload: the rasterized count matrix is integer-exact in both, and the
    downstream programs are shared."""
    import jax.numpy as jnp
    import numpy as np

    from tests.synth import make_example
    import tempfile, pathlib

    from nucleoatac_jax.config import RunConfig, WindowParams
    from nucleoatac_jax.core.chunk import ChunkList
    from nucleoatac_jax.core.pwm import PWM
    from nucleoatac_jax.io.bam import scan_bam
    from nucleoatac_jax.models.data import (
        delta12_entry_capacity,
        make_delta12_batches,
        make_pool_batches,
        pack_nibble_codes,
        tile_chunks,
    )
    from nucleoatac_jax.models.engine import DeviceEngine
    from nucleoatac_jax.models.occ import fit_mixture

    d = pathlib.Path(tempfile.mkdtemp())
    ex = make_example(d)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs, mix = fit_mixture(frags, chunks, cfg)
    eng = DeviceEngine(cfg, mix, fs, pwm=PWM.default())
    tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
    rng = np.random.default_rng(0)
    nib_rows = [
        pack_nibble_codes(
            rng.integers(0, 4, size=(4, eng.seq_codes_width())).astype(np.uint8)
        )
    ]

    outs_d12 = []
    for b in make_delta12_batches(frags, tiles, eng.width, 4):
        outs_d12.append(
            np.asarray(
                eng.run_step_delta12(jnp.asarray(b.buf), jnp.asarray(nib_rows[0]))
            )[: len(b.meta)]
        )
    outs_pool = []
    # small budget to force multiple pool groups
    for b in make_pool_batches(frags, tiles, eng.width, 4, budget=2048):
        outs_pool.append(
            np.asarray(
                eng.run_step_pool(
                    jnp.asarray(b.pool), jnp.asarray(b.table),
                    jnp.asarray(nib_rows[0]), b.emax,
                )
            )[: len(b.meta)]
        )
    a = np.concatenate(outs_d12)
    c = np.concatenate(outs_pool)
    # tile order is identical in both batchings
    assert a.shape == c.shape
    np.testing.assert_array_equal(a, c)


def test_2bit_seq_wire_bitwise_equals_nibble():
    """Wire v9 (2-bit sequence plane + N-escape scatter) must produce a
    BITWISE-identical run_step_pool output to the nibble plane, with and
    without N codes; an over-capacity batch reports ok=False."""
    import jax.numpy as jnp
    import numpy as np

    from tests.synth import make_example
    import tempfile, pathlib

    from nucleoatac_jax.config import RunConfig, WindowParams
    from nucleoatac_jax.core.chunk import ChunkList
    from nucleoatac_jax.core.pwm import PWM
    from nucleoatac_jax.io.bam import scan_bam
    from nucleoatac_jax.models.data import (
        make_pool_batches,
        pack_2bit_codes,
        pack_nibble_codes,
        tile_chunks,
    )
    from nucleoatac_jax.models.engine import DeviceEngine
    from nucleoatac_jax.models.occ import fit_mixture

    d = pathlib.Path(tempfile.mkdtemp())
    ex = make_example(d)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs, mix = fit_mixture(frags, chunks, cfg)
    eng = DeviceEngine(cfg, mix, fs, pwm=PWM.default())
    tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
    rng = np.random.default_rng(3)
    wp = eng.seq_codes_width()
    rows = rng.integers(0, 4, size=(4, wp)).astype(np.uint8)
    # sprinkle Ns, including at codes the PWM window overlaps
    rows[0, 5:25] = 4
    rows[2, wp - 9 :] = 4
    rows[3, 100] = 4
    packed2, esc, ok = pack_2bit_codes(rows)
    assert ok
    nib = pack_nibble_codes(rows)
    for b in make_pool_batches(frags, tiles, eng.width, 4):
        a = np.asarray(
            eng.run_step_pool(
                jnp.asarray(b.pool), jnp.asarray(b.table), jnp.asarray(nib),
                b.emax,
            )
        )
        c = np.asarray(
            eng.run_step_pool2(
                jnp.asarray(b.pool), jnp.asarray(b.table),
                jnp.asarray(packed2), jnp.asarray(esc), b.emax,
            )
        )
        np.testing.assert_array_equal(a, c)
        break
    # over-capacity N batch flags not-ok
    rows_n = rows.copy()
    rows_n[1, :600] = 4
    _, _, ok2 = pack_2bit_codes(rows_n)
    assert not ok2
    # wire byte accounting: 2-bit plane is half the nibble plane
    assert packed2.nbytes * 2 <= nib.nbytes + 4
