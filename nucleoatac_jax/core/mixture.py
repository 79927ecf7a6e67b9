"""Fragment-size mixture model: NFR exponential + nucleosomal component.

Device rebuild of reference:nucleoatac/Occupancy.py ::
FragmentMixDistribution (SURVEY.md §3.2). Exact numerics pinned in
DESIGN.md §3. Runs on host in float64 — it is O(upper-lower) work done once
per run; its outputs (log-mixture tables) are what the device consumes.
"""
from __future__ import annotations

import numpy as np

from nucleoatac_jax.config import MixtureParams, OccParams
from nucleoatac_jax.core.fragmentsizes import FragmentSizes


def _gauss_kernel(sigma: float) -> np.ndarray:
    if sigma <= 0:
        return np.array([1.0])
    hw = max(1, int(round(3 * sigma)))
    x = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _smoothstep(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    t = np.clip((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fit_truncated_exponential_tau(
    sizes: np.ndarray, counts: np.ndarray, lo: int, hi: int, newton_iters: int = 50
) -> float:
    """MLE of tau for p(s) ∝ exp(-s/tau) observed only on s in [lo, hi].

    With L = hi - lo and m = mean(s - lo), the MLE solves
    m = tau - L / (exp(L/tau) - 1); fixed Newton iteration count for
    determinism (DESIGN.md §3).
    """
    sel = (sizes >= lo) & (sizes <= hi)
    s = sizes[sel].astype(np.float64)
    c = counts[sel].astype(np.float64)
    tot = c.sum()
    if tot <= 0:
        return 60.0  # degenerate input; arbitrary-but-deterministic fallback
    L = float(hi - lo)
    m = float(((s - lo) * c).sum() / tot)
    m = min(max(m, 1e-3), L / 2 - 1e-9)  # m >= L/2 has no finite solution

    tau = max(m, 1e-2)
    for _ in range(newton_iters):
        z = L / tau
        ez = np.expm1(z)  # exp(z) - 1, stable
        f = tau - L / ez - m
        # df/dtau = 1 - (L^2/tau^2) * exp(z) / ez^2
        df = 1.0 - (z * z) * (ez + 1.0) / (ez * ez)
        if df <= 1e-12:
            break
        step = f / df
        tau = float(np.clip(tau - step, 1e-2, 1e6))
    return tau


class FragmentMixDistribution:
    """p(s) = w * p_nuc(s) + (1-w) * p_nfr(s) over [lower, upper)."""

    def __init__(self, lower: int, upper: int, params: MixtureParams | None = None):
        self.lower = int(lower)
        self.upper = int(upper)
        self.params = params or MixtureParams()
        self.sizes = np.arange(self.lower, self.upper, dtype=np.float64)
        self.tau: float | None = None
        self.w: float | None = None
        self.p_nfr: np.ndarray | None = None
        self.p_nuc: np.ndarray | None = None
        self.p_data: np.ndarray | None = None

    def fit(self, fragmentsizes: FragmentSizes) -> "FragmentMixDistribution":
        mp = self.params
        counts = fragmentsizes.get(self.lower, self.upper).astype(np.float64)
        p = counts / max(counts.sum(), 1.0)
        self.p_data = p

        self.tau = fit_truncated_exponential_tau(
            self.sizes, counts, mp.nfr_fit_lo, mp.nfr_fit_hi, mp.newton_iters
        )
        nfr = np.exp(-self.sizes / self.tau)
        self.p_nfr = nfr / nfr.sum()

        ramp = _smoothstep(self.sizes, mp.ramp_lo, mp.ramp_hi)
        kern = _gauss_kernel(mp.smooth_sigma)

        def norm(x: np.ndarray) -> np.ndarray:
            s = x.sum()
            return x / s if s > 0 else np.full_like(x, 1.0 / len(x))

        w = 0.5
        p_nuc = norm(np.clip(p - self.p_nfr, 0.0, None) * ramp)
        for _ in range(mp.em_iters):
            denom = w * p_nuc + (1.0 - w) * self.p_nfr + 1e-300
            r = w * p_nuc / denom
            w = float((p * r).sum())
            w = min(max(w, 1e-6), 1.0 - 1e-6)
            p_nuc = norm(np.convolve(p * r, kern, mode="same") * ramp)
        self.w = w
        self.p_nuc = p_nuc
        return self

    # --- occupancy tables (DESIGN.md §4) -------------------------------
    def alpha_grid(self, occ: OccParams) -> np.ndarray:
        return np.linspace(0.0, 1.0, occ.grid_size, dtype=np.float64)

    def log_mix_table(self, occ: OccParams) -> np.ndarray:
        """M[s, i] = log(g_i * p_nuc(s) + (1-g_i) * p_nfr(s) + floor); float64."""
        assert self.p_nuc is not None and self.p_nfr is not None, "fit() first"
        g = self.alpha_grid(occ)[None, :]
        mix = g * self.p_nuc[:, None] + (1.0 - g) * self.p_nfr[:, None]
        return np.log(mix + occ.mix_floor)

    # --- persistence (occ_fit.txt; DESIGN.md §3) -----------------------
    def save(self, path: str) -> None:
        assert self.p_nuc is not None
        with open(path, "w") as fh:
            fh.write(f"#lower={self.lower} upper={self.upper}\n")
            fh.write(f"#tau={self.tau!r} w={self.w!r}\n")
            fh.write("#size\tp_data\tp_nfr\tp_nuc\n")
            for i, s in enumerate(self.sizes):
                fh.write(
                    f"{int(s)}\t{self.p_data[i]:.10g}\t{self.p_nfr[i]:.10g}\t{self.p_nuc[i]:.10g}\n"
                )

    @classmethod
    def open(cls, path: str) -> "FragmentMixDistribution":
        meta: dict[str, str] = {}
        rows: list[tuple[int, float, float, float]] = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line.startswith("#") and "=" in line:
                    for part in line[1:].split():
                        if "=" in part:
                            k, v = part.split("=", 1)
                            meta[k] = v
                    continue
                if line.startswith("#") or not line:
                    continue
                f = line.split("\t")
                rows.append((int(f[0]), float(f[1]), float(f[2]), float(f[3])))
        obj = cls(int(meta["lower"]), int(meta["upper"]))
        obj.tau = float(meta["tau"])
        obj.w = float(meta["w"])
        obj.p_data = np.array([r[1] for r in rows])
        obj.p_nfr = np.array([r[2] for r in rows])
        obj.p_nuc = np.array([r[3] for r in rows])
        return obj
