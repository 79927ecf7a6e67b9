#!/usr/bin/env python
"""Per-stage device profile at production shapes (VERDICT r1 item 1).

Times every chained stage of DeviceEngine (raster / occ / bias / convs /
finish), the wire (upload, compact download), and the end-to-end loop,
each with explicit block_until_ready sync, then prints a coherent table
whose rows SUM to the measured end-to-end number, plus FLOPs/window and
the achieved TF/s of the matmul stages.

Usage: python scripts/profile_stages.py [--batch 128] [--core 1024]
       [--iters 20] [--frags 2048]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, iters, sync):
    """Median-of-3 of (enqueue iters, sync once) loops."""
    fn()
    sync()
    best = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        sync() if out is None else __import__("jax").block_until_ready(out)
        best.append((time.perf_counter() - t0) / iters)
    return float(np.median(best))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--core", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frags", type=int, default=2048)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from __graft_entry__ import _tiny_engine
    from nucleoatac_jax.models.data import (
        encode_delta_fragments,
        pack_nibble_codes,
    )

    cfg, eng = _tiny_engine(core=args.core, batch=args.batch)
    B, F, W = args.batch, args.frags, eng.width
    S = cfg.sizes.upper - cfg.sizes.lower
    Sv = cfg.vmat.upper - cfg.vmat.lower
    K = cfg.vmat.width
    G = cfg.occ.grid_size
    it = args.iters
    dev = jax.devices()[0]
    print(f"# device={dev.device_kind} B={B} W={W} S={S} Sv={Sv} K={K} G={G}")

    rng = np.random.default_rng(1)
    mids = np.sort(rng.integers(0, W, size=(B, F)), axis=1).astype(np.int64)
    szs = np.clip(
        np.concatenate(
            [
                rng.normal(147, 20, size=(B, F // 2)),
                rng.exponential(45, size=(B, F - F // 2)) + 20,
            ],
            axis=1,
        ),
        1,
        250,
    ).astype(np.int64)
    szs.sort(axis=1)  # arbitrary; delta uses mids order
    db = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
    for b in range(B):
        encode_delta_fragments(mids[b], szs[b], db, b)
    wp = eng.seq_codes_width()
    nib = pack_nibble_codes(rng.integers(0, 4, size=(B, wp)).astype(np.uint8))

    sync = lambda: None  # noqa: E731

    # --- wire: upload -----------------------------------------------------
    def up():
        a = jax.device_put(db)
        b_ = jax.device_put(nib)
        return (a, b_)

    t_up = timeit(up, it, sync)
    d_db = jax.device_put(db)
    d_nib = jax.device_put(nib)
    jax.block_until_ready((d_db, d_nib))

    # --- per stage (device-resident inputs) -------------------------------
    rows = {}
    rows["upload"] = t_up

    mat = eng._raster_delta(d_db)
    jax.block_until_ready(mat)
    rows["raster"] = timeit(lambda: eng._raster_delta(d_db), it, sync)

    rows["occ_packed"] = timeit(lambda: eng._occ_packed(mat), it, sync)

    logb = eng._logbias_nib(d_nib)
    jax.block_until_ready(logb)
    rows["pwm_bias"] = timeit(lambda: eng._logbias_nib(d_nib), it, sync)

    b0 = eng._bias(logb)
    jax.block_until_ready(b0)
    rows["bias_mat"] = timeit(lambda: eng._bias(logb), it, sync)

    fo, bo = eng._convs(mat, b0)
    jax.block_until_ready((fo, bo))
    rows["convs"] = timeit(lambda: eng._convs(mat, b0), it, sync)

    rows["finish5"] = timeit(lambda: eng._finish5(fo, bo), it, sync)

    # --- wire: compact downloads ------------------------------------------
    occ_c = eng._occ_packed(mat)
    nuc_c = eng._finish5(fo, bo)
    jax.block_until_ready((occ_c, nuc_c))

    def down():
        return np.asarray(occ_c), np.asarray(nuc_c)

    rows["download"] = timeit(down, max(4, it // 2), sync)

    # --- end-to-end: chained device steps, inputs resident -----------------
    def dev_step():
        return (
            eng.occ_step_delta_c(d_db),
            eng.nuc_step_delta_seq_c(d_db, d_nib),
        )

    rows["e2e_device"] = timeit(dev_step, it, sync)

    # --- end-to-end: full loop upload + step + download ---------------------
    def full_loop():
        a = jax.device_put(db)
        nb = jax.device_put(nib)
        o = eng.occ_step_delta_c(a)
        n5 = eng.nuc_step_delta_seq_c(a, nb)
        return np.asarray(o), np.asarray(n5)

    rows["e2e_sync_loop"] = timeit(full_loop, max(4, it // 2), sync)

    # --- FLOP model ---------------------------------------------------------
    Wo = W - K + 1
    flops = {
        "occ_matmul": 2 * S * G * W,  # einsum bsw,sg
        "occ_slide": (2 * cfg.occ.flank + 1) * (G + 1) * W,  # reduce_window adds
        "convs_f": 2 * 5 * Sv * K * Wo,
        "convs_b": 2 * 3 * Sv * K * Wo,
        "bias_mat": 4 * Sv * W,
    }
    total_fpw = sum(flops.values())
    print(f"# FLOPs/window: {total_fpw/1e6:.1f} MF  " +
          " ".join(f"{k}={v/1e6:.1f}MF" for k, v in flops.items()))

    res = {}
    print(f"\n{'stage':>14}  {'ms/batch':>9}  {'us/win':>7}  {'TF/s':>6}")
    for name, t in rows.items():
        fl = 0
        if name == "convs":
            fl = (flops["convs_f"] + flops["convs_b"]) * B
        elif name == "occ_packed":
            fl = (flops["occ_matmul"] + flops["occ_slide"]) * B
        tf = fl / t / 1e12 if fl else 0.0
        print(f"{name:>14}  {t*1e3:9.2f}  {t/B*1e6:7.1f}  {tf:6.2f}")
        res[name] = t * 1e3

    stage_sum = sum(rows[k] for k in
                    ["raster", "occ_packed", "pwm_bias", "bias_mat",
                     "convs", "finish5"])
    print(f"\n# stage sum (device only): {stage_sum*1e3:.2f} ms/batch "
          f"vs e2e_device {rows['e2e_device']*1e3:.2f} ms/batch")
    print(f"# windows/s: device-resident={B/rows['e2e_device']:.0f} "
          f"sync-loop={B/rows['e2e_sync_loop']:.0f}")
    print(json.dumps({"B": B, "W": W, "ms": res,
                      "wps_device": B / rows["e2e_device"],
                      "wps_sync_loop": B / rows["e2e_sync_loop"]}))


if __name__ == "__main__":
    main()
