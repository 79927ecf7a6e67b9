"""Device engine: jitted batched window steps for the occ and nuc stages.

This replaces the reference's per-chunk worker functions
(reference:nucleoatac/Occupancy.py :: OccChunk.process and
NucleosomeCalling.py :: NucChunk.process — SURVEY.md §4.1/§4.2) with
fixed-shape jit-compiled programs over [B, F] fragment tensors
(DESIGN.md §10). Parameters (log-mixture table, template kernels, size
distribution) are closed over as device constants — replicated under
sharding (SURVEY.md §3.3).

The pipeline is FIVE small jitted stages chained through device-resident
intermediates (rasterize, occupancy, bias matrix, conv stack, elementwise
finish) rather than one fused program. Each stage compiles and is tested
on its own, and the wire-format variants below share the same downstream
executables, which keeps their outputs bitwise equal.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.fragmentsizes import FragmentSizes
from nucleoatac_jax.core.mixture import FragmentMixDistribution
from nucleoatac_jax.core.vmat import VMat
from nucleoatac_jax.ops import (
    bias_mat_batch,
    gauss_kernel,
    gauss_smooth_batch,
    occupancy_batch,
    rasterize_batch,
    rasterize_delta_batch,
    rasterize_packed_batch,
)
from nucleoatac_jax.ops.xcorr import (
    CONV_PRECISION,
    _conv_stack,
    build_kernels,
    build_kernels_diag,
    nuc_conv_outputs_diag,
)


class OccTracks(NamedTuple):
    occ: jax.Array
    lower: jax.Array
    upper: jax.Array
    n: jax.Array
    margin: jax.Array  # f64-certification margins; see ops/occupancy.py
    ci_margin: jax.Array


class NucTracks(NamedTuple):
    norm: jax.Array
    norm_smooth: jax.Array
    signal: jax.Array
    lr: jax.Array
    fuzz: jax.Array
    n: jax.Array


class DeviceEngine:
    def __init__(
        self,
        cfg: RunConfig,
        mix: FragmentMixDistribution,
        fragmentsizes: FragmentSizes,
        vmat: VMat | None = None,
        mesh=None,
        pwm=None,
        conv_mode: str = "diag",
    ):
        self.cfg = cfg
        if conv_mode not in ("diag", "direct"):
            raise ValueError(
                f"conv_mode must be 'diag' or 'direct', not {conv_mode!r}"
            )
        self.conv_mode = conv_mode
        self.width = cfg.window.width(cfg.occ, cfg.vmat)
        self.halo = cfg.window.halo(cfg.occ, cfg.vmat)
        # Occupancy tables (float64 host -> float32 constants). Every
        # table the jitted impls close over is kept as a host numpy array,
        # never a committed jax.Array: numpy constants embed into the
        # program at trace time without a device->host fetch.
        self.log_mix64 = mix.log_mix_table(cfg.occ)  # float64, host checks
        self.alpha_grid64 = mix.alpha_grid(cfg.occ)
        self.log_mix = np.asarray(self.log_mix64, np.float32)
        self.alpha_grid = np.asarray(self.alpha_grid64, np.float32)
        # template + kernels
        self.vmat = vmat or VMat.default(cfg.vmat)
        if (self.vmat.lower, self.vmat.upper) != (cfg.vmat.lower, cfg.vmat.upper):
            raise ValueError("VMat size range does not match config")
        self.f_kernels, self.b_kernels = build_kernels(
            self.vmat.mat, cfg.nuc.v_floor
        )
        self._diag_kernels = build_kernels_diag(self.vmat.mat, cfg.nuc.v_floor)
        # genome-wide nuc-range size distribution q(s) (DESIGN.md §6)
        h = fragmentsizes.get(cfg.vmat.lower, cfg.vmat.upper).astype(np.float64)
        tot = h.sum()
        q = h / tot if tot > 0 else np.full_like(h, 1.0 / len(h))
        self.size_probs64 = q  # float64, for the host f64 refinisher
        self.size_probs = np.asarray(q, np.float32)
        self.smooth_kernel = np.asarray(gauss_kernel(cfg.nuc.smooth_sd))
        # optional on-device Tn5 bias from sequence codes (ops/pwmseq.py)
        self.pwm = pwm
        if pwm is not None:
            self.pwm_log_ratio = np.asarray(pwm.log_ratio(), np.float32)
        # core span inside the window for bias-row normalization
        self.core_lo = self.halo
        self.core_hi = self.width - self.halo
        # true core (output) span: [halo, halo + core); columns beyond it
        # are halo/dead-padding and never reach output tracks
        self.core = cfg.window.core

        self.mesh = mesh
        jit_kwargs: Dict = {}
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            if cfg.window.batch % mesh.size != 0:
                raise ValueError(
                    f"window batch {cfg.window.batch} not divisible by mesh "
                    f"size {mesh.size}"
                )
            data = NamedSharding(mesh, P("data"))
            jit_kwargs = {"in_shardings": data, "out_shardings": data}
        self._raster = jax.jit(self._raster_impl, **jit_kwargs)
        self._raster_packed = jax.jit(self._raster_packed_impl, **jit_kwargs)
        self._raster_delta = jax.jit(self._raster_delta_impl, **jit_kwargs)
        self._raster_delta12 = jax.jit(self._raster_delta12_impl, **jit_kwargs)
        # pool raster (wire v7): the record pool is REPLICATED across the
        # mesh (every device's windows gather anywhere in it); only the
        # per-window table shards on 'data'
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            repl = NamedSharding(mesh, P())
            data_s = NamedSharding(mesh, P("data"))
            # emax is static and positional: pjit rejects kwargs when
            # in_shardings is given
            self._raster_pool = jax.jit(
                self._raster_pool_impl, static_argnums=(2,),
                in_shardings=(repl, data_s), out_shardings=data_s,
            )
        else:
            self._raster_pool = jax.jit(
                self._raster_pool_impl, static_argnums=(2,)
            )
        if pwm is not None:
            self._logbias_seq = jax.jit(self._logbias_seq_impl, **jit_kwargs)
            self._logbias_nib = jax.jit(self._logbias_nib_impl, **jit_kwargs)
            self._logbias_2bit = jax.jit(self._logbias_2bit_impl, **jit_kwargs)
        self._occ_from_mat = jax.jit(self._occ_from_mat_impl, **jit_kwargs)
        self._occ_packed = jax.jit(self._occ_packed_impl, **jit_kwargs)
        self._occ_packed3 = jax.jit(self._occ_packed3_impl, **jit_kwargs)
        self._occ_packed2 = jax.jit(self._occ_packed2_impl, **jit_kwargs)
        self._finish2 = jax.jit(self._finish2_impl, **jit_kwargs)
        self._nuc1m = jax.jit(self._nuc1m_impl, **jit_kwargs)
        self._u24 = jax.jit(self._u24_impl, **jit_kwargs)
        self._u16 = jax.jit(self._u16_impl, **jit_kwargs)
        self._pack_run = jax.jit(self._pack_run_impl, **jit_kwargs)
        self._bias = jax.jit(self._bias_impl, **jit_kwargs)
        self._convs = jax.jit(self._convs_impl, **jit_kwargs)
        self._finish = jax.jit(self._finish_impl, **jit_kwargs)
        self._finish5 = jax.jit(self._finish5_impl, **jit_kwargs)

    # ---------------- stage impls (pure) --------------------------------
    def _raster_impl(self, mids, sizes, valid):
        """Optional on-device rasterization from fragment lists; the
        production path feeds host-rasterized dense mats instead
        (models/data.py :: DenseBatch)."""
        return rasterize_batch(
            mids, sizes, valid, self.cfg.sizes.lower, self.cfg.sizes.upper, self.width
        )

    def _raster_packed_impl(self, packed):
        """On-device rasterization from packed `(size<<16)|mid` fragment
        words — the production transfer format (one int32 array per batch
        instead of mids/sizes/valid; models/data.py :: pack_fragments)."""
        return rasterize_packed_batch(
            packed, self.cfg.sizes.lower, self.cfg.sizes.upper, self.width
        )

    def _raster_delta_impl(self, db):
        """On-device rasterization from 2-byte delta-coded fragments —
        the production wire format (models/data.py :: DeltaBatch; half
        the bytes of the int32 packed words)."""
        return rasterize_delta_batch(
            db, self.cfg.sizes.lower, self.cfg.sizes.upper, self.width
        )

    def _raster_delta12_impl(self, buf):
        """On-device rasterization from the 12-bit/record wire-v6 upload
        (models/data.py :: Delta12Batch; 25% fewer bytes than delta —
        the upload stream binds e2e once the v5 download shrank below
        it). Record count is recovered from the buffer width
        (M = E//2 + E, E even)."""
        from nucleoatac_jax.ops.rasterize import rasterize_delta12_batch

        E = 2 * buf.shape[1] // 3
        return rasterize_delta12_batch(
            buf, E, self.cfg.sizes.lower, self.cfg.sizes.upper, self.width
        )

    def _raster_pool_impl(self, pool, table, emax):
        """On-device rasterization from the chunk-resident record pool
        (wire v7, models/data.py :: PoolBatch): fragments upload once per
        group; windows carry a 12-byte table row. Downstream programs are
        the SAME as the per-window formats, so outputs are bitwise
        identical (tests/test_transfer.py)."""
        from nucleoatac_jax.ops.rasterize import rasterize_pool_batch

        return rasterize_pool_batch(
            pool, table, emax,
            self.cfg.sizes.lower, self.cfg.sizes.upper, self.width,
        )

    def _logbias_nib_impl(self, packed_codes):
        """Nibble-packed uint8 base codes (2 per byte) -> [B, W] f32 log
        bias (ops/pwmseq.py :: pwm_bias_batch_nibble); half the sequence
        wire bytes of the plain uint8 row."""
        from nucleoatac_jax.ops.pwmseq import pwm_bias_batch_nibble

        return pwm_bias_batch_nibble(
            packed_codes, self.seq_codes_width(), self.pwm_log_ratio
        )

    def _logbias_2bit_impl(self, packed2, esc):
        """2-bit-packed uint8 base codes (4 per byte) + N-escape list ->
        [B, W] f32 log bias (wire v9, ops/pwmseq.py ::
        pwm_bias_batch_2bit); quarter the sequence wire bytes of the
        plain uint8 row, half the nibble row's."""
        from nucleoatac_jax.ops.pwmseq import pwm_bias_batch_2bit

        return pwm_bias_batch_2bit(
            packed2, self.seq_codes_width(), esc, self.pwm_log_ratio
        )

    def _logbias_seq_impl(self, codes):
        """uint8 base codes over [win_start - pwm.up, win_end + pwm.down)
        -> [B, W] f32 log bias on device (ops/pwmseq.py). Replaces the
        host PWM loop + f32 bias upload: 4x fewer wire bytes."""
        from nucleoatac_jax.ops.pwmseq import pwm_bias_batch

        return pwm_bias_batch(codes, self.pwm_log_ratio)

    def seq_codes_width(self) -> int:
        """Wire width of the per-window sequence-code row."""
        return self.width + self.pwm.length - 1

    def _occ_from_mat_impl(self, mat) -> OccTracks:
        mat = mat.astype(jnp.float32)  # int16 counts uploaded; cast on device
        out = occupancy_batch(
            mat, self.log_mix, self.alpha_grid, self.cfg.occ.flank, self.cfg.occ.ci_drop
        )
        return OccTracks(
            out.occ, out.lower, out.upper, out.n, out.margin, out.ci_margin
        )

    def _occ_packed_impl(self, mat):
        """Wire-optimized occ finisher: uint8 [B, 4, W] grid indices +
        certified flag (ops/occupancy.py :: occupancy_packed) — ONE small
        download per batch instead of six f32 tracks."""
        from nucleoatac_jax.ops.occupancy import occupancy_packed

        mat = mat.astype(jnp.float32)
        return occupancy_packed(
            mat, self.log_mix, self.cfg.occ.flank, self.cfg.occ.ci_drop,
            self.cfg.occ.exact_tol,
        )

    def _finish5_impl(self, fo, bo):
        """NucTracks stacked into one f32 [B, 5, W] (norm, norm_smooth,
        signal, lr, fuzz) — ONE download per batch instead of five."""
        t = self._finish_impl(fo, bo)
        return jnp.stack([t.norm, t.norm_smooth, t.signal, t.lr, t.fuzz], axis=1)

    def _occ_packed3_impl(self, mat):
        """Wire v2 occ finisher: uint8 [B, 3, core] grid indices with the
        certified flag in bit 7 of channel 0 (ops/occupancy.py ::
        occupancy_packed3) — core-only columns, halving download bytes vs
        occupancy_packed."""
        from nucleoatac_jax.ops.occupancy import occupancy_packed3

        return occupancy_packed3(
            mat.astype(jnp.float32), self.log_mix, self.cfg.occ.flank,
            self.core_lo, self.core, self.cfg.occ.ci_drop,
            self.cfg.occ.exact_tol,
        )

    def _finish2_impl(self, fo, bo):
        """Wire v2 nuc finisher: f32 [B, 2, core] (norm, norm_smooth),
        core-only. The per-dyad stats (z, lr, signal, fuzz) are refinished
        in float64 on host at candidate positions (models/nuc_exact.py),
        so their per-bp tracks never need downloading."""
        t = self._finish_impl(fo, bo)
        out = jnp.stack([t.norm, t.norm_smooth], axis=1)
        return out[:, :, self.core_lo : self.core_lo + self.core]

    def smooth_margin(self) -> int:
        """Columns of norm needed on each side of the core to reproduce
        the device's per-window gaussian smooth on host."""
        return len(self.smooth_kernel) // 2

    def _nuc1m_impl(self, fo, bo):
        """Wire v3 nuc finisher: f32 [B, core + 2*smooth_margin] norm only
        (no smooth channel — the smoothed track is a deterministic
        convolution of norm, recomputed on host from the margin-extended
        core slice; models/nuc.py :: host_smooth). Halves nuc download
        bytes again vs _finish2."""
        t = self._finish_impl(fo, bo)
        m = self.smooth_margin()
        return t.norm[:, self.core_lo - m : self.core_lo + self.core + m]

    @staticmethod
    def _u24_impl(x):
        """f32 [..., N] -> uint8 [..., N, 3]: drop the low mantissa byte
        with round-to-nearest-magnitude (wire v4). Deterministic; max
        relative error 2^-16 ~ 1.5e-5 — the same class as the accepted
        |f32 - f64| deviation (config.NucParams.exact_tol covers both),
        and far below the mirror-comparison tolerances. Saves 25% of the
        norm download."""
        u = jax.lax.bitcast_convert_type(x, jnp.uint32)
        u = (u + 0x80) >> 8  # carries propagate = correct float rounding
        return jnp.stack(
            [u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], axis=-1
        ).astype(jnp.uint8)

    @staticmethod
    def f32_from_u24(b: np.ndarray) -> np.ndarray:
        """Host decode of _u24_impl output: uint8 [..., N, 3] -> f32."""
        u = (
            b[..., 0].astype(np.uint32)
            | (b[..., 1].astype(np.uint32) << 8)
            | (b[..., 2].astype(np.uint32) << 16)
        ) << 8
        return u.view(np.float32)

    @staticmethod
    def _u16_impl(x):
        """f32 [B, N] -> uint8 [B, 2N+8]: per-row affine u16 quantization
        (wire v5). Layout per row: N low bytes, N high bytes, then
        min (f32 LE) and scale (f32 LE). q = round((x-min)/scale) with
        scale = (max-min)/65535, so |decode - x| <= scale/2 — the decoder
        reports scale so the exact-mode tie guard can WIDEN its margin
        threshold by the quantization step (models/nuc.py), keeping the
        f64-certification sound for arbitrary value ranges (pathological
        windows just trigger more f64 fallbacks). Saves another third of
        the norm download vs u24."""
        mn = jnp.min(x, axis=1, keepdims=True)
        rng = jnp.max(x, axis=1, keepdims=True) - mn
        scale = rng / 65535.0
        safe = jnp.where(scale > 0, scale, 1.0)
        q = jnp.clip(jnp.round((x - mn) / safe), 0, 65535).astype(jnp.uint32)

        def f32b(v):  # [B, 1] f32 -> [B, 4] uint8 little-endian
            u = jax.lax.bitcast_convert_type(v, jnp.uint32)
            return jnp.concatenate(
                [((u >> (8 * i)) & 0xFF).astype(jnp.uint8) for i in range(4)],
                axis=1,
            )

        meta = jnp.concatenate(
            [f32b(mn), f32b(jnp.where(scale > 0, scale, 0.0))], axis=1
        )
        return jnp.concatenate(
            [(q & 0xFF).astype(jnp.uint8), (q >> 8).astype(jnp.uint8), meta],
            axis=1,
        )

    @staticmethod
    def f32_from_u16(buf: np.ndarray):
        """Host decode of _u16_impl output: uint8 [B, 2N+8] ->
        (norm f32 [B, N], qstep f64 [B]) where qstep = per-row scale
        (a >=2x-conservative bound on the quantization error scale/2,
        leaving headroom for the f32 decode arithmetic)."""
        B, M = buf.shape
        N = (M - 8) // 2
        q = buf[:, :N].astype(np.uint16) | (
            buf[:, N : 2 * N].astype(np.uint16) << 8
        )
        meta = np.ascontiguousarray(buf[:, 2 * N :])
        mn = meta[:, 0:4].copy().view(np.float32).reshape(B, 1)
        scale = meta[:, 4:8].copy().view(np.float32).reshape(B, 1)
        norm = mn + q.astype(np.float32) * scale
        return norm, scale[:, 0].astype(np.float64)


    def _occ_packed2_impl(self, mat, return_ll=False):
        """Wire v8 occ finisher: uint8 [B, 2*core + ceil(core/4)] —
        argmax index + certified bit, CI bounds as 5-bit deltas (low
        nibbles + packed hi-bit plane; ops/occupancy.py ::
        occupancy_packed2). Requires occ.exact (delta overflow falls back
        to the f64 refinisher via the cleared certified flag).
        ``return_ll`` adds the f32 core LL surface as a second output."""
        from nucleoatac_jax.ops.occupancy import occupancy_packed2

        return occupancy_packed2(
            mat.astype(jnp.float32), self.log_mix, self.cfg.occ.flank,
            self.core_lo, self.core, self.cfg.occ.ci_drop,
            self.cfg.occ.exact_tol, return_ll=return_ll,
        )

    def _pack_run_impl(self, occ2, norm_packed):
        """Fused-run download, wire v4/v5: ONE uint8 buffer per batch —
        packed2 occ grid indices + packed norm (u24: [B, 2*core +
        3*(core+2m)]; u16 affine: [B, 2*core + 2*(core+2m)+8]) — so the
        full occ+nuc pipeline pays a single upload and a single download
        per batch (models/fused.py) at ~4 bytes/bp instead of round 2's 7.
        The norm
        arrives from the standalone _u24/_u16 program (see _nucm24 note
        on byte-identity)."""
        B = occ2.shape[0]
        return jnp.concatenate(
            [occ2.reshape(B, -1), norm_packed.reshape(B, -1)], axis=1
        )

    def _bias_impl(self, log_bias):
        return bias_mat_batch(
            log_bias,
            self.size_probs,
            self.cfg.vmat.lower,
            self.cfg.vmat.upper,
            self.core_lo,
            self.core_hi,
        )

    def _convs_impl(self, mat, b0, precision=CONV_PRECISION):
        """Full-size-range mat -> nuc-range conv stacks, dyad-aligned.

        Default path is the diag-matmul restructure (ops/xcorr.py ::
        nuc_conv_outputs_diag: one batched GEMM per stack plus a diagonal
        sum); conv_mode='direct' keeps the original two XLA convs for
        comparison. ``precision`` is the matmul precision of every conv;
        the production value is ops/xcorr.py :: CONV_PRECISION."""
        vlo = self.cfg.vmat.lower - self.cfg.sizes.lower
        vup = self.cfg.vmat.upper - self.cfg.sizes.lower
        fmat = mat[:, vlo:vup, :].astype(jnp.float32)
        K = self.f_kernels.shape[2]
        half = K // 2
        W = fmat.shape[2]
        pad = ((0, 0), (0, 0), (half, W - half - (W - K + 1)))
        if self.conv_mode == "diag":
            fo, bo = nuc_conv_outputs_diag(
                fmat, b0, *self._diag_kernels, precision=precision
            )
            return jnp.pad(fo, pad), jnp.pad(bo, pad)
        fo = jnp.pad(_conv_stack(fmat, self.f_kernels, precision), pad)
        bo = jnp.pad(_conv_stack(b0, self.b_kernels, precision), pad)
        return fo, bo

    def _finish_impl(self, fo, bo) -> NucTracks:
        p = self.cfg.nuc
        signal, n, flogv, foff, foff2 = (fo[:, i] for i in range(5))
        bsum, vb, v2b = (bo[:, i] for i in range(3))
        safe_b = jnp.where(bsum > 0, bsum, 1.0)
        mu = vb / safe_b
        mu2 = v2b / safe_b
        exp_signal = n * mu
        var = n * (mu2 - mu * mu)
        ok = (var > p.var_floor) & (n > 0)
        norm = jnp.where(
            ok, (signal - exp_signal) * jax.lax.rsqrt(jnp.where(ok, var, 1.0)), 0.0
        )
        lr = jnp.where(n > 0, flogv - n * jnp.log(jnp.maximum(mu, 1e-30)), 0.0)
        safe_n = jnp.where(n > 0, n, 1.0)
        m1 = foff / safe_n
        m2 = foff2 / safe_n
        fuzz = jnp.where(n > 0, jnp.sqrt(jnp.maximum(m2 - m1 * m1, 0.0)), 0.0)
        norm_smooth = gauss_smooth_batch(norm, self.smooth_kernel)
        return NucTracks(norm, norm_smooth, signal, lr, fuzz, n)

    # ---------------- public steps (chained jits) -----------------------
    # Fragment-list entry points (separate mids/sizes/valid arrays):
    def occ_step_frags(self, mids, sizes, valid) -> OccTracks:
        return self._occ_from_mat(self._raster(mids, sizes, valid))

    def nuc_step_frags(self, mids, sizes, valid, log_bias) -> NucTracks:
        return self.nuc_step(self._raster(mids, sizes, valid), log_bias)

    def full_step_frags(self, mids, sizes, valid, log_bias):
        return self.full_step(self._raster(mids, sizes, valid), log_bias)

    # Packed-word entry points (production transfer format):
    def occ_step_packed(self, packed) -> OccTracks:
        return self._occ_from_mat(self._raster_packed(packed))

    def nuc_step_packed(self, packed, log_bias) -> NucTracks:
        return self.nuc_step(self._raster_packed(packed), log_bias)

    def full_step_packed(self, packed, log_bias):
        return self.full_step(self._raster_packed(packed), log_bias)

    # Sequence-code entry points (device PWM bias; requires pwm=...):
    def nuc_step_packed_seq(self, packed, codes) -> NucTracks:
        return self.nuc_step(self._raster_packed(packed), self._logbias_seq(codes))

    def full_step_packed_seq(self, packed, codes):
        return self.full_step(self._raster_packed(packed), self._logbias_seq(codes))

    # Delta-coded entry points (production wire format; DESIGN.md §10):
    def occ_step_delta(self, db) -> OccTracks:
        return self._occ_from_mat(self._raster_delta(db))

    def nuc_step_delta(self, db, log_bias) -> NucTracks:
        return self.nuc_step(self._raster_delta(db), log_bias)

    def nuc_step_delta_seq(self, db, packed_codes) -> NucTracks:
        return self.nuc_step(self._raster_delta(db), self._logbias_nib(packed_codes))

    def full_step_delta_seq(self, db, packed_codes):
        return self.full_step(self._raster_delta(db), self._logbias_nib(packed_codes))

    # Compact-download entry points: stage drivers pull ONE array per
    # batch instead of five/six:
    def occ_step_delta_c(self, db):
        """-> uint8 [B, 4, W] (argmax/lo/up grid indices + certified flag;
        ops/occupancy.py :: occupancy_packed). Lossless: occupancy values
        live on the discrete alpha grid, decoded with the f64 grid on
        host (models/occ.py)."""
        return self._occ_packed(self._raster_delta(db))

    def occ_step_packed_c(self, packed):
        return self._occ_packed(self._raster_packed(packed))

    def occ_step_c(self, mat):
        return self._occ_packed(mat)

    def _nuc5(self, mat, log_bias):
        """f32 [B, 5, W] (norm, norm_smooth, signal, lr, fuzz) stacked
        into one download."""
        return self._finish5(*self._convs(mat, self._bias(log_bias)))

    def _nuc2(self, mat, log_bias):
        """Wire v2: f32 [B, 2, core] (norm, norm_smooth) — the only per-bp
        nuc tracks that reach output files; stats refinish on host."""
        return self._finish2(*self._convs(mat, self._bias(log_bias)))

    def _nucm(self, mat, log_bias):
        """f32 [B, core + 2m] norm with smooth margins (wire v3)."""
        return self._nuc1m(*self._convs(mat, self._bias(log_bias)))

    # Wire-v3 nuc entry points (norm-with-margin; host recomputes smooth):
    def nuc_step_delta_seq_m(self, db, packed_codes):
        return self._nucm(self._raster_delta(db), self._logbias_nib(packed_codes))

    def nuc_step_delta_m(self, db, log_bias):
        return self._nucm(self._raster_delta(db), log_bias)

    def nuc_step_packed_seq_m(self, packed, codes):
        return self._nucm(self._raster_packed(packed), self._logbias_seq(codes))

    def nuc_step_packed_m(self, packed, log_bias):
        return self._nucm(self._raster_packed(packed), log_bias)

    def nuc_step_frags_m(self, mids, sizes, valid, log_bias):
        return self._nucm(self._raster(mids, sizes, valid), log_bias)

    def nuc_step_dense_m(self, mat, log_bias):
        return self._nucm(mat, log_bias)

    # Fused-run entry point: the whole occ+nuc pipeline from one upload to
    # one packed download per batch (models/fused.py; chained jits, not a
    # single fused program — see the module docstring).
    def run_step_delta(self, db, packed_codes):
        mat = self._raster_delta(db)
        occ2 = self._occ_packed2(mat)
        norm16 = self._u16(self._nucm(mat, self._logbias_nib(packed_codes)))
        return self._pack_run(occ2, norm16)

    def unpack_run(self, buf: np.ndarray):
        """Host-side decode of run_step_delta output (wire v5):
        (idx int64 [B, 3, core] = decoded argmax/CI-lo/CI-up grid
        indices, cert bool [B, core], norm f32 [B, core+2m], qstep f64
        [B] = per-window norm quantization scale). Positions with
        cert == False carry placeholder CI indices and MUST be
        f64-refinished (models/occ.py :: _exact_refinish); the nuc tie
        guard widens its margin threshold by max(qstep) of the chunk
        (models/nuc.py :: _tie_guard)."""
        n_occ = 2 * self.core + (self.core + 3) // 4
        idx, cert = self.decode_occ2(buf[:, :n_occ])
        norm, qstep = self.f32_from_u16(buf[:, n_occ:])
        return idx, cert, norm, qstep

    def decode_occ2(self, raw: np.ndarray):
        """uint8 [B, 2*core + ceil(core/4)] (occupancy_packed2, wire v8:
        argmax byte + CI-delta low-nibble byte + packed 5th delta bits)
        -> (idx int64 [B, 3, core] clipped to the grid, cert bool
        [B, core])."""
        G = self.log_mix.shape[1]
        n = self.core
        raw = raw.astype(np.int64)
        ch0, ch1, hib = raw[:, :n], raw[:, n : 2 * n], raw[:, 2 * n :]
        best = ch0 & 0x7F
        cert = (ch0 >> 7).astype(bool)
        # expand the 2-bit hi plane: position p's bits live in byte p//4
        # at bit offset 2*(p%4)
        p = np.arange(n)
        hi2 = (hib[:, p // 4] >> (2 * (p % 4))) & 3
        lo_d = (ch1 & 0xF) | ((hi2 & 1) << 4)
        up_d = (ch1 >> 4) | ((hi2 >> 1) << 4)
        lo = best - lo_d
        up = np.minimum(best + up_d, G - 1)
        return np.stack([best, lo, up], axis=1), cert

    # Wire-v7 pool entry points (chunk-resident fragment pool; same
    # downstream programs — only rasterization differs):
    def run_step_pool(self, pool, table, packed_codes, emax: int):
        mat = self._raster_pool(pool, table, emax)
        occ2 = self._occ_packed2(mat)
        norm16 = self._u16(self._nucm(mat, self._logbias_nib(packed_codes)))
        return self._pack_run(occ2, norm16)

    def run_step_pool2(self, pool, table, packed2, esc, emax: int):
        """Wire v7 fragments + wire v9 2-bit sequence plane (the
        production fused dispatch when a batch's N count fits the escape
        list; models/fused.py falls back to run_step_pool otherwise).
        Identical downstream executables — outputs bitwise-equal to the
        nibble form (pinned in test_transfer)."""
        mat = self._raster_pool(pool, table, emax)
        occ2 = self._occ_packed2(mat)
        norm16 = self._u16(
            self._nucm(mat, self._logbias_2bit(packed2, esc))
        )
        return self._pack_run(occ2, norm16)

    def occ_step_pool_p2(self, pool, table, emax: int):
        return self._occ_packed2(self._raster_pool(pool, table, emax))

    def nuc_step_pool_seq_m16(self, pool, table, packed_codes, emax: int):
        return self._nucm16(
            self._raster_pool(pool, table, emax),
            self._logbias_nib(packed_codes),
        )

    # Wire-v6 upload entry points (12-bit fragment records; same
    # downstream programs as the delta set — only rasterization differs):
    def run_step_delta12(self, buf, packed_codes):
        mat = self._raster_delta12(buf)
        occ2 = self._occ_packed2(mat)
        norm16 = self._u16(self._nucm(mat, self._logbias_nib(packed_codes)))
        return self._pack_run(occ2, norm16)

    def occ_step_delta12_p2(self, buf):
        return self._occ_packed2(self._raster_delta12(buf))

    def occ_step_delta12_c3(self, buf):
        return self._occ_packed3(self._raster_delta12(buf))

    def nuc_step_delta12_seq_m16(self, buf, packed_codes):
        return self._nucm16(
            self._raster_delta12(buf), self._logbias_nib(packed_codes)
        )

    def nuc_step_delta12_m16(self, buf, log_bias):
        return self._nucm16(self._raster_delta12(buf), log_bias)

    def nuc_step_delta12_seq_c(self, buf, packed_codes):
        return self._nuc5(
            self._raster_delta12(buf), self._logbias_nib(packed_codes)
        )

    def nuc_step_delta12_c(self, buf, log_bias):
        return self._nuc5(self._raster_delta12(buf), log_bias)

    # Wire-v4 occ entry points (2-byte packed; REQUIRES occ.exact —
    # CI-delta overflow routes through the f64 refinisher):
    def occ_step_delta_p2(self, db):
        return self._occ_packed2(self._raster_delta(db))

    def occ_step_packed_p2(self, packed):
        return self._occ_packed2(self._raster_packed(packed))

    def occ_step_p2(self, mat):
        return self._occ_packed2(mat)

    # Wire-v4 nuc entry points (u24 norm-with-margin; decode with
    # f32_from_u24 then host_smooth):
    def _nucm24(self, mat, log_bias):
        # the u24 truncation runs as its OWN jitted program on _nucm's
        # output, so the f32 norm it truncates is bitwise THE SAME values
        # the fused run_step_delta truncates (same executable) — keeping
        # fused == two-pass outputs byte-identical (tests/test_fused.py)
        return self._u24(self._nucm(mat, log_bias))

    # Wire-v5 nuc entry points (u16 affine-quantized norm-with-margin;
    # decode with f32_from_u16 then host_smooth):
    def _nucm16(self, mat, log_bias):
        # like _nucm24: the u16 quantization runs as its OWN jitted
        # program on _nucm's output, so fused and two-pass paths quantize
        # bitwise-identical f32 values -> byte-identical downloads
        # (tests/test_fused.py)
        return self._u16(self._nucm(mat, log_bias))

    def nuc_step_delta_seq_m16(self, db, packed_codes):
        return self._nucm16(self._raster_delta(db), self._logbias_nib(packed_codes))

    def nuc_step_delta_m16(self, db, log_bias):
        return self._nucm16(self._raster_delta(db), log_bias)

    def nuc_step_packed_seq_m16(self, packed, codes):
        return self._nucm16(self._raster_packed(packed), self._logbias_seq(codes))

    def nuc_step_packed_m16(self, packed, log_bias):
        return self._nucm16(self._raster_packed(packed), log_bias)

    def nuc_step_frags_m16(self, mids, sizes, valid, log_bias):
        return self._nucm16(self._raster(mids, sizes, valid), log_bias)

    def nuc_step_dense_m16(self, mat, log_bias):
        return self._nucm16(mat, log_bias)

    def nuc_step_delta_seq_m24(self, db, packed_codes):
        return self._nucm24(self._raster_delta(db), self._logbias_nib(packed_codes))

    def nuc_step_delta_m24(self, db, log_bias):
        return self._nucm24(self._raster_delta(db), log_bias)

    def nuc_step_packed_seq_m24(self, packed, codes):
        return self._nucm24(self._raster_packed(packed), self._logbias_seq(codes))

    def nuc_step_packed_m24(self, packed, log_bias):
        return self._nucm24(self._raster_packed(packed), log_bias)

    def nuc_step_frags_m24(self, mids, sizes, valid, log_bias):
        return self._nucm24(self._raster(mids, sizes, valid), log_bias)

    def nuc_step_dense_m24(self, mat, log_bias):
        return self._nucm24(mat, log_bias)

    # Wire-v2 entry points (core-only compact downloads):
    def occ_step_delta_c3(self, db):
        return self._occ_packed3(self._raster_delta(db))

    def occ_step_packed_c3(self, packed):
        return self._occ_packed3(self._raster_packed(packed))

    def occ_step_c3(self, mat):
        return self._occ_packed3(mat)

    def nuc_step_delta_seq_c2(self, db, packed_codes):
        return self._nuc2(self._raster_delta(db), self._logbias_nib(packed_codes))

    def nuc_step_delta_c2(self, db, log_bias):
        return self._nuc2(self._raster_delta(db), log_bias)

    def nuc_step_packed_seq_c2(self, packed, codes):
        return self._nuc2(self._raster_packed(packed), self._logbias_seq(codes))

    def nuc_step_packed_c2(self, packed, log_bias):
        return self._nuc2(self._raster_packed(packed), log_bias)

    def nuc_step_frags_c2(self, mids, sizes, valid, log_bias):
        return self._nuc2(self._raster(mids, sizes, valid), log_bias)

    def nuc_step_dense_c2(self, mat, log_bias):
        return self._nuc2(mat, log_bias)

    def nuc_step_delta_seq_c(self, db, packed_codes):
        return self._nuc5(self._raster_delta(db), self._logbias_nib(packed_codes))

    def nuc_step_delta_c(self, db, log_bias):
        return self._nuc5(self._raster_delta(db), log_bias)

    def nuc_step_packed_seq_c(self, packed, codes):
        return self._nuc5(self._raster_packed(packed), self._logbias_seq(codes))

    def nuc_step_packed_c(self, packed, log_bias):
        return self._nuc5(self._raster_packed(packed), log_bias)

    def nuc_step_frags_c(self, mids, sizes, valid, log_bias):
        return self._nuc5(self._raster(mids, sizes, valid), log_bias)

    def nuc_step_dense_c(self, mat, log_bias):
        return self._nuc5(mat, log_bias)

    # Dense-matrix entry points (host-rasterized int16 fallback):
    # mat: [B, S_full, W] counts, cast to f32 on device
    def occ_step(self, mat) -> OccTracks:
        return self._occ_from_mat(mat)

    def nuc_step(self, mat, log_bias) -> NucTracks:
        fo, bo = self._convs(mat, self._bias(log_bias))
        return self._finish(fo, bo)

    def full_step(self, mat, log_bias):
        occ = self._occ_from_mat(mat)
        fo, bo = self._convs(mat, self._bias(log_bias))
        return occ, self._finish(fo, bo)

    # Single-traceable fused forms (multichip dryrun + compile checks);
    # production runs the chained stages above.
    def full_impl_frags(self, mids, sizes, valid, log_bias):
        return self.full_impl(self._raster_impl(mids, sizes, valid), log_bias)

    def full_impl_packed(self, packed, log_bias):
        return self.full_impl(self._raster_packed_impl(packed), log_bias)

    def full_impl_packed_seq(self, packed, codes):
        return self.full_impl(
            self._raster_packed_impl(packed), self._logbias_seq_impl(codes)
        )

    def full_impl_delta_seq(self, db, packed_codes):
        return self.full_impl(
            self._raster_delta_impl(db), self._logbias_nib_impl(packed_codes)
        )

    def full_impl(self, mat, log_bias):
        occ = self._occ_from_mat_impl(mat)
        fo, bo = self._convs_impl(mat, self._bias_impl(log_bias))
        return occ, self._finish_impl(fo, bo)

    def occ_impl(self, mat) -> OccTracks:
        return self._occ_from_mat_impl(mat)

    def nuc_impl(self, mat, log_bias) -> NucTracks:
        fo, bo = self._convs_impl(mat, self._bias_impl(log_bias))
        return self._finish_impl(fo, bo)
