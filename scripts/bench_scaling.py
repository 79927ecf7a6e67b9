#!/usr/bin/env python
"""Scaling benchmark: windows/s at 1..N devices over the 'data' mesh.

BASELINE.md north star: windows/s efficiency at 1 chip / 1 host / N
hosts. With real multi-chip hardware this measures true weak scaling
(fixed per-device batch). With only one chip (or on the CPU backend with
--virtual N) it still validates the sharded path end-to-end, but the
"devices" share one chip's/host's compute, so efficiency numbers are NOT
meaningful hardware scaling — the harness prints a warning and marks the
records virtual.

Usage:
  python scripts/bench_scaling.py                 # real devices
  python scripts/bench_scaling.py --virtual 8     # 8 virtual CPU devices
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=None,
                    help="force N virtual CPU devices")
    ap.add_argument("--per-device-batch", type=int, default=16)
    ap.add_argument("--frag-cap", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    from __graft_entry__ import _tiny_engine
    from nucleoatac_jax.models.data import pack_fragments
    from nucleoatac_jax.parallel import make_mesh

    n_total = len(jax.devices())
    virtual = bool(args.virtual) or n_total == 1
    if virtual and not args.virtual:
        print("# WARNING: one real device; pass --virtual N to exercise "
              "the sharded path (numbers are not hardware scaling)",
              file=sys.stderr)

    sizes_list = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]
    base_wps = None
    rng = np.random.default_rng(1)
    for n in sizes_list:
        B = args.per_device_batch * n
        mesh = make_mesh(n) if n > 1 else None
        cfg, eng = _tiny_engine(core=1024, batch=B, mesh=mesh)
        W, F = eng.width, args.frag_cap
        mids = rng.integers(0, W, size=(B, F)).astype(np.int32)
        szs = np.clip(rng.normal(147, 40, size=(B, F)).astype(np.int32), 1, 250)
        packed = np.zeros((B, F), np.int32)
        for b in range(B):
            pack_fragments(mids[b], szs[b], packed, b)
        codes = rng.integers(0, 4, size=(B, eng.seq_codes_width())).astype(np.uint8)
        dev_in = (jnp.asarray(packed), jnp.asarray(codes))
        jax.block_until_ready(dev_in)
        out = eng.full_step_packed_seq(*dev_in)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = eng.full_step_packed_seq(*dev_in)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / args.iters)
        wps = B / best
        if base_wps is None:
            base_wps = wps
        print(json.dumps({
            "devices": n,
            "batch": B,
            "windows_per_s": round(wps, 1),
            "weak_scaling_efficiency": round(wps / (base_wps * n), 3),
            "virtual": virtual,
        }))


if __name__ == "__main__":
    main()
