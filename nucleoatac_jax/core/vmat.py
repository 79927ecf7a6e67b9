"""V-plot template: open/save/symmetrize/smooth/trim/normalize + default.

Rebuild of reference:nucleoatac/VMat.py :: VMat (SURVEY.md §3.2). The
template is a [S, K] matrix, rows = adjusted fragment sizes in
[lower, upper), columns = midpoint offset from the dyad, K odd, dyad at
column K//2. ``vprocess`` (reference `nucleoatac vprocess`) is
``VMat.process_raw``. The reference ships a pre-built template as package
data; that artifact is unavailable (empty reference mount, SURVEY.md §0),
so ``VMat.default()`` generates a deterministic synthetic V-plot per
DESIGN.md §9 — callers can always supply ``--vmat``.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from nucleoatac_jax.config import VMatParams


class VMat:
    def __init__(self, mat: np.ndarray, lower: int, upper: int):
        mat = np.asarray(mat, dtype=np.float64)
        if mat.shape[0] != upper - lower:
            raise ValueError(f"mat rows {mat.shape[0]} != upper-lower {upper - lower}")
        if mat.shape[1] % 2 != 1:
            raise ValueError("template width must be odd (centered dyad)")
        self.mat = mat
        self.lower = int(lower)
        self.upper = int(upper)

    @property
    def width(self) -> int:
        return self.mat.shape[1]

    @property
    def w(self) -> int:
        """Half-width: dyad column index."""
        return self.mat.shape[1] // 2

    # --- processing steps (DESIGN.md §9) --------------------------------
    def symmetrize(self) -> "VMat":
        self.mat = 0.5 * (self.mat + self.mat[:, ::-1])
        return self

    def smooth(self, sd_size: float = 1.0, sd_pos: float = 1.0) -> "VMat":
        if sd_size > 0 or sd_pos > 0:
            self.mat = gaussian_filter(self.mat, sigma=(sd_size, sd_pos), mode="constant")
        return self

    def norm(self) -> "VMat":
        self.mat = np.clip(self.mat, 0.0, None)
        s = self.mat.sum()
        if s > 0:
            self.mat = self.mat / s
        return self

    def trim(self, lower: int, upper: int, width: int) -> "VMat":
        if lower < self.lower or upper > self.upper or width > self.width:
            raise ValueError("cannot trim outwards")
        if width % 2 != 1:
            raise ValueError("trimmed width must be odd")
        c = self.w
        hw = width // 2
        self.mat = self.mat[lower - self.lower : upper - self.lower, c - hw : c + hw + 1]
        self.lower, self.upper = lower, upper
        return self

    @classmethod
    def process_raw(
        cls, raw: np.ndarray, raw_lower: int, params: VMatParams | None = None
    ) -> "VMat":
        """`nucleoatac vprocess`: raw aggregate V-plot -> calling template."""
        p = params or VMatParams()
        v = cls(raw, raw_lower, raw_lower + raw.shape[0])
        v.trim(p.lower, p.upper, p.width)
        v.symmetrize()
        v.smooth(p.smooth_sd_size, p.smooth_sd_pos)
        v.norm()
        return v

    @classmethod
    def default(cls, params: VMatParams | None = None) -> "VMat":
        """Deterministic synthetic template (DESIGN.md §9):
        T[s,k] ∝ rho(s) * phi(k; 0, sigma(s)), rho = N(147, 22),
        sigma(s) = 4 + |s-147|/4, then the vprocess pipeline."""
        p = params or VMatParams()
        sizes = np.arange(p.lower, p.upper, dtype=np.float64)
        k = np.arange(p.width, dtype=np.float64) - p.width // 2
        rho = np.exp(-0.5 * ((sizes - 147.0) / 22.0) ** 2)
        sigma = 4.0 + np.abs(sizes - 147.0) / 4.0
        phi = np.exp(-0.5 * (k[None, :] / sigma[:, None]) ** 2) / sigma[:, None]
        v = cls(rho[:, None] * phi, p.lower, p.upper)
        v.symmetrize()
        v.smooth(p.smooth_sd_size, p.smooth_sd_pos)
        v.norm()
        return v

    # --- 1-D projections (reference VMat.converto1d) --------------------
    def position_profile(self) -> np.ndarray:
        return self.mat.sum(axis=0)

    def size_profile(self) -> np.ndarray:
        return self.mat.sum(axis=1)

    # --- persistence (text format with size-range metadata) -------------
    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(f"#lower={self.lower} upper={self.upper} width={self.width}\n")
            np.savetxt(fh, self.mat, fmt="%.10g", delimiter="\t")

    @classmethod
    def open(cls, path: str) -> "VMat":
        with open(path) as fh:
            header = fh.readline().strip()
            kv = dict(p.split("=") for p in header[1:].split())
            mat = np.loadtxt(fh, delimiter="\t", ndmin=2)
        v = cls(mat, int(kv["lower"]), int(kv["upper"]))
        if v.width != int(kv["width"]):
            raise ValueError("VMat width metadata mismatch")
        return v
