from nucleoatac_jax.ops.rasterize import (
    rasterize_batch,
    rasterize_delta_batch,
    rasterize_packed_batch,
    unpack_delta_fragments,
    unpack_fragments,
)
from nucleoatac_jax.ops.occupancy import occupancy_batch
from nucleoatac_jax.ops.biasmat import bias_mat_batch
from nucleoatac_jax.ops.xcorr import nuc_scores_batch
from nucleoatac_jax.ops.smooth import gauss_smooth_batch, gauss_kernel
from nucleoatac_jax.ops.peaks import local_max_batch, greedy_select_batch

__all__ = [
    "rasterize_batch",
    "rasterize_delta_batch",
    "rasterize_packed_batch",
    "unpack_delta_fragments",
    "unpack_fragments",
    "occupancy_batch",
    "bias_mat_batch",
    "nuc_scores_batch",
    "gauss_smooth_batch",
    "gauss_kernel",
    "local_max_batch",
    "greedy_select_batch",
]
