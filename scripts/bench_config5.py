#!/usr/bin/env python
"""BASELINE config 5: genome-wide MULTI-SAMPLE run sharded across N>=2
hosts with collective merge (BASELINE.json configs[4]; VERDICT r4 next
item 2 — the one prescribed benchmark config never executed at scale).

For each of ``--samples`` synthetic samples (different seeds), this
driver:

1. runs the production CLI `nucleoatac run --num_hosts N --host_id k`
   once per shard (SEPARATE processes, the real multi-host entry path —
   run one after another here; real hosts run them concurrently, so the
   critical-path wall is max(shard walls) + the host-0 finalize). Each
   shard process sees one card of its own through CUDA_VISIBLE_DEVICES
   (shard k gets card k mod the number of cards): a JAX process reserves
   most of a card's memory, so two processes cannot share one,
2. runs `--finalize` (shard concatenation + tabix re-index + merge/nfr),
3. runs a single-host reference `nucleoatac run` on the same sample,
4. byte-compares every merged output file against the single-host run,
5. prints walls and parallel efficiency as one JSON line.

Usage: python scripts/bench_config5.py [--peaks 10000] [--hosts 2]
       [--samples 2] [--platform cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OUTPUTS = [
    ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
    ".nucleoatac_signal.bedgraph.gz", ".nucleoatac_signal.smooth.bedgraph.gz",
    ".nucpos.bed.gz", ".nucpos.redundant.bed.gz",
    ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
]


def n_cards() -> int:
    """Visible NVIDIA cards, counted without opening JAX (0 if none)."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def run_cli(args_list, platform, log_path, card=None):
    """One production-CLI process, on card ``card`` alone when given;
    returns (wall_s, max_rss_mb)."""
    import resource

    env = dict(os.environ)
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    cmd = [sys.executable, "-m", "nucleoatac_jax.cli.nucleoatac"] + args_list
    if platform:
        cmd += ["--platform", platform]
    before = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    t0 = time.perf_counter()
    with open(log_path, "ab") as log:
        log.write((" ".join(cmd) + "\n").encode())
        subprocess.run(cmd, cwd=REPO, env=env, stdout=log, stderr=log,
                       check=True)
    wall = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return wall, max(after, before) / 1024


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks", type=int, default=10000)
    ap.add_argument("--frags-per-peak", type=int, default=500)
    ap.add_argument("--chroms", type=int, default=10)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--skip-single", action="store_true",
                    help="reuse an existing single-host reference run")
    ap.add_argument("--workdir", default="/tmp")
    args = ap.parse_args()

    from bench_e2e import synth_dataset

    cards = n_cards()

    results = []
    for si in range(args.samples):
        seed = 7 + 14 * si  # sample 0 = the config-4 dataset (cached)
        bam, bed, fa = synth_dataset(
            args.workdir, args.chroms, args.peaks, 2000,
            args.frags_per_peak, seed=seed,
        )
        base = os.path.join(args.workdir, f"nucleoatac_cfg5_s{si}")
        os.makedirs(base, exist_ok=True)
        log = os.path.join(base, "cli.log")
        common = ["run", "--bam", bam, "--bed", bed, "--fasta", fa]

        shard_walls = []
        out_sh = os.path.join(base, "sharded")
        for k in range(args.hosts):
            w, _ = run_cli(
                common + ["--out", out_sh, "--num_hosts", str(args.hosts),
                          "--host_id", str(k)],
                args.platform, log, card=k % cards if cards else None,
            )
            shard_walls.append(round(w, 1))
            print(f"# sample {si} shard {k}/{args.hosts}: {w:.1f} s",
                  flush=True)
        t_fin, rss_fin = run_cli(
            common + ["--out", out_sh, "--num_hosts", str(args.hosts),
                      "--finalize"],
            args.platform, log, card=0 if cards else None,
        )
        print(f"# sample {si} finalize: {t_fin:.1f} s", flush=True)

        out_1 = os.path.join(base, "single")
        if args.skip_single and os.path.exists(
            out_1 + ".nfrpos.bed.gz"
        ):
            t_single = None
        else:
            t_single, _ = run_cli(
                common + ["--out", out_1], args.platform, log,
                card=0 if cards else None,
            )
            print(f"# sample {si} single-host: {t_single:.1f} s", flush=True)

        same, diff = [], []
        for sfx in OUTPUTS:
            a, b = out_sh + sfx, out_1 + sfx
            if not (os.path.exists(a) and os.path.exists(b)):
                diff.append(sfx + " (missing)")
            elif open(a, "rb").read() == open(b, "rb").read():
                same.append(sfx)
            else:
                diff.append(sfx)
        crit = max(shard_walls) + t_fin
        eff = (t_single / args.hosts) / crit if t_single else None
        results.append({
            "sample": si, "seed": seed, "shard_walls_s": shard_walls,
            "finalize_s": round(t_fin, 1),
            "critical_path_s": round(crit, 1),
            "single_host_s": round(t_single, 1) if t_single else None,
            "parallel_efficiency": round(eff, 3) if eff else None,
            "outputs_identical": len(diff) == 0,
            "diff_files": diff,
        })
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"config5": results}))


if __name__ == "__main__":
    main()
