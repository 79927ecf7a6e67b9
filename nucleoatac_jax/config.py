"""Stage parameter dataclasses (DESIGN.md defaults).

The reference exposes these as argparse flags on ``nucleoatac
{occ,nuc,nfr,merge,run}`` (reference: nucleoatac/cli.py :: nucleoatac_parser);
here each stage has a frozen dataclass consumed by the engines in
``nucleoatac_jax.models`` and mirrored by the CLI layer.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class IngestParams:
    """Fragment filtering at BAM ingest (DESIGN.md §1)."""

    min_mapq: int = 30
    max_size: int = 2000
    atac: bool = True  # apply +4/-5 Tn5 insertion offsets


@dataclass(frozen=True)
class SizesParams:
    """Fragment-size histogram support (DESIGN.md §2)."""

    lower: int = 0
    upper: int = 251


@dataclass(frozen=True)
class MixtureParams:
    """NFR/nucleosomal fragment-size mixture fit (DESIGN.md §3)."""

    nfr_fit_lo: int = 20
    nfr_fit_hi: int = 120
    ramp_lo: int = 100
    ramp_hi: int = 115
    em_iters: int = 25
    newton_iters: int = 50
    smooth_sigma: float = 3.0


@dataclass(frozen=True)
class OccParams:
    """Per-bp occupancy MLE + CI + occ peaks (DESIGN.md §4)."""

    flank: int = 60  # window = 2*flank+1 bp
    grid_size: int = 101  # alpha in {0, .01, ..., 1}
    ci_drop: float = 1.92  # chi2(1) 95% / 2
    min_occ: float = 0.1  # lower-bound threshold for occ peaks
    occ_sep: int = 120  # min distance between occ peaks
    mix_floor: float = 1e-10
    # f64-exact finishing (DESIGN.md §4): positions whose device LL
    # margins fall below exact_tol are re-finished on host in float64
    # from the raw fragment lists, making occ/lower/upper outputs equal
    # to the f64 mirror's grid selections
    exact: bool = True
    # bound on |LL_f32 device - LL_f64|. The LL einsum runs at HIGHEST
    # matmul precision (full f32 products; ops/occupancy.py ::
    # _ll_and_n), so the error is at the f32-accumulation level: measured
    # max 1.7e-4 on CPU-XLA, and chip_smoke.py phase b measures it on the
    # card (PARITY.md, "Certification tolerances"). The rule is a margin
    # of at least 4x over every backend. A tighter tolerance certifies
    # more positions at low coverage: on the 30-frags/window synth, tol
    # 5e-3 certified 33% of positions (the argmax margin scales with
    # window counts) while 1e-3 certifies 83% (with the wire v8 5-bit CI
    # deltas). A runtime spot-check guards the margin on every run
    # (models/occ.py :: _spot_check). The LL is CONCAVE in alpha, so
    # min_g |ll_g - thr| is always attained boundary-adjacent - scoping
    # the min to the CI boundary (measured) changes nothing.
    exact_tol: float = 1e-3


@dataclass(frozen=True)
class VMatParams:
    """Template size/position support (DESIGN.md §9)."""

    lower: int = 105
    upper: int = 251
    width: int = 147  # odd; dyad at width//2
    smooth_sd_size: float = 1.0
    smooth_sd_pos: float = 1.0


@dataclass(frozen=True)
class NucParams:
    """Dyad-calling stage (DESIGN.md §7)."""

    smooth_sd: float = 10.0
    nuc_sep: int = 120
    min_z: float = 3.0
    min_lr: float = 0.0
    v_floor: float = 1e-5
    var_floor: float = 1e-12
    # f64-exact finishing (models/nuc_exact.py, DESIGN.md §12): printed
    # per-dyad stats and the candidate mask are recomputed in float64 on
    # host; selection decisions whose f32 score margins fall below
    # 2*exact_tol are settled individually on f64 point values
    # (SmoothResolver). exact_tol bounds |f32 device track - f64 mirror
    # track|: measured max ~2e-4 on CPU-XLA -> 8e-4 is a 4x margin.
    # The conv stack runs at ops/xcorr.py :: CONV_PRECISION (full f32
    # products on every backend), and chip_smoke.py phase b measures the
    # error on the card (PARITY.md, "Certification tolerances"). Round 5
    # lowered it from 2e-3: the ambiguous-comparison count — and with it
    # the SmoothResolver's share of chunk-finishing wall — scales
    # linearly with the tie-guard width 2*(exact_tol + qstep/2), and 4x
    # is the same multiplier the occ tolerance uses.
    exact: bool = True
    exact_tol: float = 8e-4
    # strict: additionally refinish the smoothed-score column of every
    # printed row in f64 (costly on few host cores; the column is f32
    # otherwise, everything else in the row is f64 either way)
    strict: bool = False


@dataclass(frozen=True)
class NFRParams:
    """NFR calling (DESIGN.md §8)."""

    max_occ_upper: float = 0.25
    min_nfr_len: int = 10
    max_nfr_len: int = 1000
    nuc_half: int = 73  # bp excluded on each side of a called dyad


@dataclass(frozen=True)
class WindowParams:
    """Fixed-shape window tiling (DESIGN.md §10)."""

    core: int = 1024
    # windows per device batch: each batch costs one upload, one codes
    # upload and one download, so bigger batches amortize the per-transfer
    # cost; 64 divides any power-of-two device mesh
    batch: int = 64
    frag_cap: int = 32768  # padded fragments per batch bucket
    # host->device transfer format. "pool" (wire v7, round-4 default):
    # fragments upload ONCE per chunk group as a device-resident 12-bit
    # record stream, windows ship 12-byte table rows (DESIGN.md §10) —
    # 56 vs 116 KB/batch upload at B=128, bitwise-identical outputs;
    # standalone occ/nuc stages fall back to delta12.
    # "delta12" uploads per-window 12-bit records (wire v6);
    # "delta" uploads 2-byte (delta, size)
    # uint8 pairs (+ nibble-packed sequence codes for the nuc stage) and
    # decodes/rasterizes on device; "packed" uploads int32
    # (size<<16)|mid words; "frags" uploads separate mids/sizes/valid
    # arrays; "dense" uploads host-rasterized int16 count matrices
    transfer: str = "pool"
    # concurrent device->host fetch threads in the pipelined batch loop
    # (models/occ.py :: _pipelined): each thread materializes one batch's
    # result while the main thread keeps dispatching. 0 = serial
    # async-copy pipelining only.
    fetch_threads: int = 8
    # worker threads for per-chunk host finishing in the fused run path
    # (models/fused.py: occ f64 refinish + peak calling + nuc selection +
    # RLE/format — GIL-releasing C++/BLAS). -1 = auto (min(4, cpus));
    # 0 = serial. Writes always stay genome-ordered on the main thread.
    finish_threads: int = -1
    # conv-stack implementation for the nuc template xcorr: "diag" (XLA
    # batched GEMM + diagonal sum, default) or "direct" (two XLA convs)
    conv: str = "diag"

    def halo(self, occ: OccParams, vmat: VMatParams) -> int:
        """Context needed on each side of a window core so every per-core
        output (sliding occupancy window, template footprint, bias shifts)
        sees only real data."""
        return max(occ.flank, vmat.width // 2 + (vmat.upper - 1) // 2 + 1)

    def width(self, occ: OccParams, vmat: VMatParams) -> int:
        """Padded device width: core + halos, rounded up to a lane multiple.
        The valid region is [halo, halo+core); columns past core+2*halo are
        dead right-padding."""
        w = self.core + 2 * self.halo(occ, vmat)
        return w + ((-w) % 128)


@dataclass(frozen=True)
class RunConfig:
    """Everything for a full `nucleoatac run`."""

    ingest: IngestParams = dataclasses.field(default_factory=IngestParams)
    sizes: SizesParams = dataclasses.field(default_factory=SizesParams)
    mixture: MixtureParams = dataclasses.field(default_factory=MixtureParams)
    occ: OccParams = dataclasses.field(default_factory=OccParams)
    vmat: VMatParams = dataclasses.field(default_factory=VMatParams)
    nuc: NucParams = dataclasses.field(default_factory=NucParams)
    nfr: NFRParams = dataclasses.field(default_factory=NFRParams)
    window: WindowParams = dataclasses.field(default_factory=WindowParams)

    def __post_init__(self) -> None:
        # The delta wire format carries sizes in one uint8 (saturating at
        # 255), so any size >= 255 would collapse into the 255 bin and be
        # miscounted when upper > 255. Refuse rather than silently corrupt;
        # the CLI falls back to "packed" with a warning (cli/nucleoatac.py).
        if (
            self.window.transfer in ("delta", "delta12", "pool")
            and self.sizes.upper > 255
        ):
            raise ValueError(
                f"sizes.upper={self.sizes.upper} > 255 is incompatible with "
                f"the '{self.window.transfer}' wire format (uint8 size "
                "field saturates at 255); use transfer='packed' or lower "
                "--upper"
            )
        # occupancy_packed ships grid indices as uint8
        if self.occ.grid_size > 256:
            raise ValueError(
                f"occ.grid_size={self.occ.grid_size} > 256 overflows the "
                "uint8 grid-index wire format (ops/occupancy.py)"
            )
