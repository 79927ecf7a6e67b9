"""Device-mesh data parallelism over candidate peak windows.

Device-mesh replacement for the reference's multiprocessing pool
(reference:run_occ.py/run_nuc.py pool setup — SURVEY.md §3.3): windows are
sharded along a 1-D ``('data',)`` mesh axis; model parameters (log-mixture
table, V-plot template kernels, size distribution, PWM) are replicated by
closure; the genome-wide fragment-size histogram is the one genuinely
collective reduction (psum over the mesh). Multi-host runs initialize via
``jax.distributed`` and reuse these same shardings (ICI within a slice,
DCN across hosts).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def sharded_size_histogram(mesh: Mesh, lower: int, upper: int):
    """Returns a jitted fn(sizes[B,F] int32, valid[B,F] bool) -> hist[S]
    computing the global fragment-size histogram with a psum across the
    windows axis (DESIGN.md §10; the reference computes this serially in
    FragmentSizes.calculateSizes)."""
    S = upper - lower

    def local(sizes, valid):
        keep = valid & (sizes >= lower) & (sizes < upper)
        idx = jnp.clip(sizes - lower, 0, S - 1)
        onehot = jax.nn.one_hot(
            jnp.where(keep, idx, S), S + 1, dtype=jnp.float32
        )[..., :S]
        local_hist = onehot.sum(axis=(0, 1))
        return jax.lax.psum(local_hist, "data")

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", None)),
        out_specs=P(),
    )
    return jax.jit(fn)


def sharded_full_step(engine, mesh: Mesh):
    """jit of the fused occ+nuc window step with windows sharded over the
    'data' axis and all parameters replicated. Per-window outputs come
    back sharded the same way; the host gathers genome-ordered results
    (the reference's writer-process queues — SURVEY.md §3.3 row 2)."""
    data = NamedSharding(mesh, P("data"))
    return jax.jit(
        engine.full_impl_frags,  # (mids, sizes, valid [B,F]; log_bias [B,W])
        in_shardings=(data, data, data, data),
        out_shardings=data,  # pytree prefix: every output sharded on windows
    )
