#!/usr/bin/env python
"""Proof that `nucleoatac run` runs on an NVIDIA GPU, and is right there.

    python chip_smoke.py               # one card: phases a-e below
    python chip_smoke.py --four-cards  # the four-card mesh path only

Phases, in order; each one is fatal on failure:

a. Build the native libraries from the tracked sources, print the card
   and JAX's devices, and refuse any backend but the GPU.
b. Run the production device stages (models/selfcheck.py) at production
   widths on synthetic batches and compare each f32 output with the
   float64 mirror against OccParams/NucParams.exact_tol; time the nuc
   conv stage alone for each implementation and precision.
c. Run `nucleoatac run` through the CLI, in this process, on BASELINE
   config 4 (scripts/bench_e2e.py :: synth_dataset: 10 contigs x 1,000
   peaks x 2 kbp, 500 fragments per peak); print the stage times and
   windows/s and check the ten outputs and their tabix indexes.
d. Re-run the first 200 peaks on the CPU in a subprocess
   (JAX_PLATFORMS=cpu, which never opens the card) and byte-compare the
   certified outputs with the GPU's run of the same peaks. Both runs use
   --strict, so the nucpos smoothed-score column is f64 on both.
e. Run the card-only tests (`pytest -m gpu tests/`) in this process.

With --four-cards the script runs config 4 on all four cards in this
process, where `auto_mesh` splits each 64-window batch 16 per card, and
once before that on card 0 alone (a separate process, before this one
opens any card) at --batch 16, so that each card runs the same 16-window
programs as the one card. It byte-compares all ten outputs. Phase b
prints whether a 16-window and a 64-window batch give the same f32
results for the same windows; the sha256 of every output is printed, so
the mesh's outputs can be set beside phase c's 64-window run.

The last line of standard output is one JSON object, printed only when
every phase passed: {"ok": true, "device": {"platform", "kind", "count"}}.
Generated data and outputs go to .chip_smoke/ in the checkout.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")

# BASELINE config 4 (BASELINE.json configs[3]): 10 contigs x 1,000 peaks
CONFIG4 = dict(n_chroms=10, n_peaks=10_000, peak_bp=2000, frags_per_peak=500)
PARITY_PEAKS = 200

OUTPUTS = [
    ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
    ".nucleoatac_signal.bedgraph.gz", ".nucleoatac_signal.smooth.bedgraph.gz",
    ".nucpos.bed.gz", ".nucpos.redundant.bed.gz",
    ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
]
# outputs the certification layer makes equal to the float64 mirror on
# every backend (the signal tracks are f32 device values)
CERTIFIED = [
    ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz", ".nucpos.bed.gz",
    ".nucpos.redundant.bed.gz", ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
]


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(backend: str, devices) -> None:
    """Refuse to go on unless JAX runs on the GPU: a silent fall back to
    the CPU would make every later number a CPU number."""
    if backend != "gpu" or not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else None
        raise SmokeFailure(
            f"no GPU: jax.default_backend()={backend!r}, "
            f"jax.devices()[0].platform={platform!r}"
        )


def result_line(devices) -> str:
    """The contract's last line: ok plus the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def card_info() -> str:
    """`nvidia-smi` name and power limit, one line per card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi unavailable: {e}"


def build_native() -> None:
    """Both native libraries, built with io/native/Makefile from the
    tracked sources (under the loader's file lock)."""
    from nucleoatac_jax.io.native import build

    for name in ("nucio", "nucrefine"):
        build(name)


def open_gpu(n_cards: int):
    """Phase a's device half: JAX's devices, which must be n_cards GPUs."""
    import jax

    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    devices = jax.devices()
    say(f"jax {jax.__version__}: {devices}")
    require_gpu(jax.default_backend(), devices)
    if len(devices) != n_cards:
        raise SmokeFailure(f"expected {n_cards} card(s), JAX sees {len(devices)}")
    return devices


# ---------------------------------------------------------------- phase b
def _time_ms(fn, *args, reps: int = 20) -> float:
    """Median wall time of fn(*args) in ms, synced on the result, after
    a compile and a warm-up call."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def phase_b(core: int = 1024, batch: int = 64) -> None:
    import functools

    import jax
    import jax.numpy as jnp

    from nucleoatac_jax.models import selfcheck
    from nucleoatac_jax.models.data import pack_2bit_codes
    from nucleoatac_jax.ops.xcorr import CONV_PRECISION

    HIGH = jax.lax.Precision.HIGH
    eng = selfcheck.make_engine(core=core, batch=batch)
    cfg = eng.cfg
    say(f"[b] engine: core={cfg.window.core} batch={cfg.window.batch} "
        f"sizes {cfg.sizes.lower}-{cfg.sizes.upper} V-plot "
        f"{cfg.vmat.lower}-{cfg.vmat.upper} K={cfg.vmat.width} "
        f"width={eng.width} pwm=on conv={eng.conv_mode}")
    # window depths around config 4's ~0.25 fragments/bp (~384 per window)
    batches = [selfcheck.synth_windows(eng, n, seed=s)
               for n, s in ((300, 1), (400, 2), (500, 3))]
    errs = [selfcheck.stage_errors(eng, *b) for b in batches]
    ll = max(e.ll_max for e in errs)
    norm = max(e.norm_max for e in errs)
    n_cert = sum(e.n_certified for e in errs)
    n_wrong = sum(e.n_picks_wrong for e in errs)
    occ_tol, nuc_tol = cfg.occ.exact_tol, cfg.nuc.exact_tol
    say(f"[b] occ: max |LL_f32 - LL_f64| = {ll!r} (occ.exact_tol "
        f"{occ_tol}, margin {occ_tol / ll:.2f}x; einsum precision HIGHEST); "
        f"certified picks {n_cert}, differing from f64 {n_wrong}")
    say(f"[b] nuc: max |norm_f32 - norm_f64| = {norm!r} (nuc.exact_tol "
        f"{nuc_tol}, margin {nuc_tol / norm:.2f}x; conv precision "
        f"{CONV_PRECISION.name})")
    ref = selfcheck.mirror_windows(eng, *batches[1])
    alt = selfcheck.stage_errors(eng, *batches[1], conv_precision=HIGH,
                                 reference=ref)
    say(f"[b] nuc at conv precision HIGH (not in force): max |norm_f32 - "
        f"norm_f64| = {alt.norm_max!r}, margin {nuc_tol / alt.norm_max:.2f}x")
    deep = selfcheck.stage_errors(
        eng, *selfcheck.synth_windows(eng, 1500, seed=4)
    )
    say(f"[b] deep windows, 1500 fragments (not gated): max |LL diff| = "
        f"{deep.ll_max!r}, max |norm diff| = {deep.norm_max!r}, certified "
        f"picks differing from f64 {deep.n_picks_wrong}")
    if ll > occ_tol or norm > nuc_tol or n_wrong or not n_cert:
        raise SmokeFailure("device stages disagree with the f64 mirror")

    # the four-card mesh runs these programs at batch / 4 windows per
    # card: the same windows in a smaller batch (not gated)
    sub = batch // 4
    eng_sub = selfcheck.make_engine(core=core, batch=sub)
    mids, sizes, codes = batches[1]
    mat = selfcheck.raster(eng, mids, sizes)
    mat_sub = selfcheck.raster(eng_sub, mids[:sub], sizes[:sub])
    n_full = np.asarray(selfcheck.nuc_norm(eng, mat, codes))[:sub]
    n_sub = np.asarray(selfcheck.nuc_norm(eng_sub, mat_sub, codes[:sub]))
    occ_same = np.array_equal(np.asarray(eng._occ_packed2(mat))[:sub],
                              np.asarray(eng_sub._occ_packed2(mat_sub)))
    say(f"[b] the same {sub} windows in a {sub}- and a {batch}-window "
        f"batch: occ bytes equal {occ_same}; nuc norm bitwise equal "
        f"{np.array_equal(n_full.view(np.uint32), n_sub.view(np.uint32))}, "
        f"max |diff| = {float(np.abs(n_full - n_sub).max())!r} (not gated)")

    # conv stage alone, at the same widths
    pool, table, emax = selfcheck.pool_batch(mids, sizes)
    pool, table = jnp.asarray(pool), jnp.asarray(table)
    packed2, esc, _ = pack_2bit_codes(codes)
    packed2, esc = jnp.asarray(packed2), jnp.asarray(esc)
    b0 = eng._bias(eng._logbias_2bit(packed2, esc))
    eng_direct = selfcheck.make_engine(core=core, batch=batch, conv="direct")
    B, W, K = cfg.window.batch, eng.width, cfg.vmat.width
    h_mb = B * 2 * K * W * 4 / 1e6
    times = {
        f"diag {CONV_PRECISION.name} (production)": _time_ms(eng._convs, mat, b0),
        "diag HIGH": _time_ms(jax.jit(functools.partial(
            eng._convs_impl, precision=HIGH)), mat, b0),
        f"direct {CONV_PRECISION.name}": _time_ms(eng_direct._convs, mat, b0),
        "full run_step_pool2": _time_ms(
            functools.partial(eng.run_step_pool2, emax=emax),
            pool, table, packed2, esc),
    }
    for name, ms in times.items():
        say(f"[b] time per {B}-window batch, {name}: {ms:.3f} ms")
    say(f"[b] H per diag stack per batch: [{B}, {2 * K}, {W}] f32 = "
        f"{h_mb:.1f} MB")


# ---------------------------------------------------------------- phase c
class _StageTimes(logging.Handler):
    """Collects `stage_timer` durations (utils/logging.py) by name."""

    def __init__(self):
        super().__init__()
        self.times = {}

    def emit(self, record):
        if record.msg == "%s: done in %.2fs":
            self.times[record.args[0]] = record.args[1]


def _dataset(peaks: int | None = None):
    """Config-4 BAM/BED/FASTA (cached under WORK), optionally with a BED of
    its first ``peaks`` peaks."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_e2e import synth_dataset

    bam, bed, fa = synth_dataset(WORK, CONFIG4["n_chroms"], CONFIG4["n_peaks"],
                                 CONFIG4["peak_bp"], CONFIG4["frags_per_peak"])
    if peaks is not None:
        sub = os.path.join(WORK, f"peaks_first{peaks}.bed")
        with open(bed) as src, open(sub, "w") as dst:
            dst.writelines(line for _, line in zip(range(peaks), src))
        bed = sub
    return bam, bed, fa


def run_cli(bam, bed, fa, prefix, extra=()):
    """`nucleoatac run` in this process; returns (wall s, stage times)."""
    from nucleoatac_jax.cli.nucleoatac import main
    from nucleoatac_jax.utils.logging import log

    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    times = _StageTimes()
    log.addHandler(times)
    try:
        t0 = time.perf_counter()
        rc = main(["run", "--bam", bam, "--bed", bed, "--fasta", fa,
                   "--out", prefix, "--no_plots", *extra])
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(times)
    if rc != 0:
        raise SmokeFailure(f"nucleoatac run exited {rc}")
    return wall, times.times


def check_outputs(prefix: str, tag: str) -> None:
    """All ten outputs and their .tbi exist, read back through stdlib
    gzip, and answer a tabix query; prints each one's rows and sha256."""
    import hashlib

    from nucleoatac_jax.io.tabix import TabixReader

    for sfx in OUTPUTS:
        path = prefix + sfx
        for p in (path, path + ".tbi"):
            if not os.path.exists(p):
                raise SmokeFailure(f"missing output {p}")
        n_rows, first = 0, b""
        with gzip.open(path, "rb") as fh:  # reads every BGZF member
            while chunk := fh.read(1 << 24):
                if not first:
                    first = chunk.split(b"\n", 1)[0]
                n_rows += chunk.count(b"\n")
        fetched = 0
        if n_rows:
            chrom, start = first.decode().split("\t")[:2]
            fetched = sum(1 for _ in TabixReader(path).fetch(
                chrom, int(start), int(start) + 100_000))
            if not fetched:
                raise SmokeFailure(f"tabix fetch returned no rows: {path}")
        elif sfx != ".nucpos.redundant.bed.gz":
            raise SmokeFailure(f"empty output {path}")
        with open(path, "rb") as fh:
            digest = hashlib.file_digest(fh, "sha256").hexdigest()
        say(f"[{tag}] {os.path.basename(path)}: {n_rows} rows, tabix fetch "
            f"{fetched} rows, sha256 {digest}")


def n_windows(bam, bed) -> int:
    from nucleoatac_jax.config import RunConfig
    from nucleoatac_jax.core.chunk import ChunkList
    from nucleoatac_jax.io.bam import scan_bam
    from nucleoatac_jax.models.data import tile_chunks

    cfg = RunConfig()
    chunks = ChunkList.read(bed, scan_bam(bam).chrom_dict).merge()
    return len(tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat))


def phase_c() -> None:
    t0 = time.perf_counter()
    bam, bed, fa = _dataset()
    say(f"[c] config-4 dataset ready in {time.perf_counter() - t0:.1f} s")
    wall, stages = run_cli(bam, bed, fa, os.path.join(WORK, "gpu", "run"))
    n = n_windows(bam, bed)
    for name, s in stages.items():
        say(f"[c] stage {name}: {s:.2f} s")
    say(f"[c] nucleoatac run: {n} windows in {wall:.2f} s = "
        f"{n / wall:.1f} windows/s (compilation included)")
    check_outputs(os.path.join(WORK, "gpu", "run"), "c")


# ---------------------------------------------------------------- phase d
def compare(prefix_a: str, prefix_b: str, suffixes) -> list:
    """Suffixes whose files differ in any byte."""
    diff = []
    for sfx in suffixes:
        with open(prefix_a + sfx, "rb") as a, open(prefix_b + sfx, "rb") as b:
            if a.read() != b.read():
                diff.append(sfx)
    return diff


def phase_d() -> None:
    bam, bed, fa = _dataset(PARITY_PEAKS)
    gpu_prefix = os.path.join(WORK, "parity_gpu", "run")
    cpu_prefix = os.path.join(WORK, "parity_cpu", "run")
    run_cli(bam, bed, fa, gpu_prefix, ["--strict"])
    os.makedirs(os.path.dirname(cpu_prefix), exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "nucleoatac_jax.cli.nucleoatac", "run",
         "--bam", bam, "--bed", bed, "--fasta", fa, "--out", cpu_prefix,
         "--no_plots", "--strict"],
        cwd=REPO, env=env, check=True,
    )
    say(f"[d] CPU run of the first {PARITY_PEAKS} peaks: "
        f"{time.perf_counter() - t0:.1f} s")
    diff = compare(gpu_prefix, cpu_prefix, CERTIFIED)
    say(f"[d] GPU vs CPU, first {PARITY_PEAKS} peaks, --strict on both: "
        f"{len(CERTIFIED) - len(diff)}/{len(CERTIFIED)} certified outputs "
        f"byte-equal" + (f"; differ: {diff}" if diff else ""))
    if diff:
        raise SmokeFailure(f"GPU and CPU outputs differ: {diff}")


# ---------------------------------------------------------------- phase e
class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_e() -> None:
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[outcomes])
    say(f"[e] card-only tests: {outcomes.counts}")
    if rc != 0 or outcomes.counts["passed"] == 0 or any(
        outcomes.counts[k] for k in ("failed", "skipped")
    ):
        raise SmokeFailure(f"card-only tests: pytest exit {rc}, {outcomes.counts}")


# ---------------------------------------------------------------- main
def one_card() -> str:
    build_native()
    say(f"[a] card: {card_info()}")
    devices = open_gpu(1)
    say("[a] native libraries built; GPU backend confirmed")
    for phase in (phase_b, phase_c, phase_d, phase_e):
        t0 = time.perf_counter()
        phase()
        say(f"[{phase.__name__[-1]}] phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    return result_line(devices)


def four_cards() -> str:
    build_native()
    say(f"[a] cards: {card_info()}")
    bam, bed, fa = _dataset()
    sub = 64 // 4
    one = os.path.join(WORK, "card0", "run")
    os.makedirs(os.path.dirname(one), exist_ok=True)
    # one card, in its own process, before this one opens any card
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "nucleoatac_jax.cli.nucleoatac", "run",
         "--bam", bam, "--bed", bed, "--fasta", fa, "--out", one,
         "--no_plots", "--batch", str(sub)],
        cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"), check=True,
    )
    say(f"[4] one card (CUDA_VISIBLE_DEVICES=0), --batch {sub}: "
        f"{time.perf_counter() - t0:.2f} s")
    devices = open_gpu(4)
    from nucleoatac_jax.config import RunConfig
    from nucleoatac_jax.models.pipeline import auto_mesh

    mesh = auto_mesh(RunConfig())
    if mesh is None or mesh.size != 4:
        raise SmokeFailure(f"auto_mesh gave {mesh}, not a 4-card mesh")
    say(f"[4] mesh: {dict(mesh.shape)}, batch 64 -> "
        f"{64 // mesh.size} windows per card")
    four = os.path.join(WORK, "cards4", "run")
    wall, stages = run_cli(bam, bed, fa, four)
    for name, s in stages.items():
        say(f"[4] stage {name}: {s:.2f} s")
    say(f"[4] four cards: {wall:.2f} s")
    check_outputs(four, "4")
    diff = compare(four, one, OUTPUTS)
    say(f"[4] four cards vs one card at {sub} windows per batch: "
        f"{len(OUTPUTS) - len(diff)}/{len(OUTPUTS)} outputs byte-equal"
        + (f"; differ: {diff}" if diff else ""))
    if diff:
        raise SmokeFailure(f"four-card outputs differ from one card: {diff}")
    return result_line(devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    try:
        line = four_cards() if args.four_cards else one_card()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    say(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
