"""On-device Tn5 PWM bias scoring from sequence codes.

Device analogue of reference:pyatac/bias.py :: InsertionBiasTrack
.computeBias (SURVEY.md §3.1 / §4.2 hot loop 5 "PWM bias scoring over
sequence"): per-bp log bias ``B[p] = sum_col log(pwm[base(p+col-up), col]
/ 0.25)``, with non-ACGT / out-of-genome context contributing 0
(core/pwm.py :: PWM.bias_track is the host/f64 mirror).

Wire format: uint8 base codes (0..3 = ACGT, >=4 = N/out-of-genome) over
``[win_start - up, win_start + W + down)`` — 4x fewer bytes than the f32
log-bias track they replace, and the scoring moves off the host onto the
device as a one-hot x [4, L] valid conv (one_hot of codes >= 4 is all-zero,
which implements the contribute-0 rule for free).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_nibble_codes(packed: jax.Array, wp: int) -> jax.Array:
    """[B, ceil(wp/2)] uint8 nibble-packed base codes -> [B, wp] codes.

    Wire format: two 4-bit codes per byte, LOW nibble first
    (models/data.py :: pack_nibble_codes) — halves the sequence-row
    bytes. Codes 0..3 = ACGT; anything >= 4 (N / out-of-genome / the
    odd-length pad nibble) one-hots to all-zero downstream.
    """
    lo = packed & 0xF
    hi = packed >> 4
    codes = jnp.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)
    return codes[:, :wp]


def pwm_bias_batch_nibble(
    packed: jax.Array, wp: int, log_ratio: jax.Array
) -> jax.Array:
    """Nibble-packed codes -> [B, wp - L + 1] log bias (see pwm_bias_batch)."""
    return pwm_bias_batch(unpack_nibble_codes(packed, wp), log_ratio)


def unpack_2bit_codes(packed: jax.Array, wp: int, esc: jax.Array) -> jax.Array:
    """[B, ceil(wp/4)] uint8 2-bit-packed codes + [E, 2] (row, col)
    N-position escapes -> [B, wp] codes (wire v9 sequence plane,
    models/data.py :: pack_2bit_codes). Padded escape entries target the
    dead column wp of a width-(wp+1) scratch and are sliced away, so the
    scatter is a fixed-shape no-op for them."""
    parts = [(packed >> (2 * k)) & 3 for k in range(4)]
    codes = jnp.stack(parts, axis=-1).reshape(packed.shape[0], -1)[:, :wp]
    ext = jnp.concatenate(
        [codes, jnp.zeros((codes.shape[0], 1), codes.dtype)], axis=1
    )
    ext = ext.at[esc[:, 0], esc[:, 1]].set(4)
    return ext[:, :wp]


def pwm_bias_batch_2bit(
    packed: jax.Array, wp: int, esc: jax.Array, log_ratio: jax.Array
) -> jax.Array:
    """2-bit-packed codes -> [B, wp - L + 1] log bias (see pwm_bias_batch);
    quarter the sequence wire bytes of the plain uint8 row."""
    return pwm_bias_batch(unpack_2bit_codes(packed, wp, esc), log_ratio)


def pwm_bias_batch(codes: jax.Array, log_ratio: jax.Array) -> jax.Array:
    """codes: [B, W + L - 1] uint8; log_ratio: [4, L] f32 -> [B, W] f32.

    Output position p scores the context codes[p : p + L] (callers upload
    codes starting at genomic ``win_start - up``, so output column 0 is
    the window's first bp).
    """
    onehot = jax.nn.one_hot(codes, 4, dtype=jnp.float32)  # [B, Wp, 4]
    x = onehot.transpose(0, 2, 1)  # [B, 4, Wp]
    k = log_ratio[None].astype(jnp.float32)  # [1, 4, L]
    out = jax.lax.conv_general_dilated(
        x, k, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]
