"""Square-lattice geometry: neighbor tables, k-grids, dispersion.

Port of ``dwavehmc_tpu/models/lattice.py`` (numpy only, kept as its own copy
so the port never imports the JAX package).  Site index convention: 0-based
``i = y * Lx + x`` with periodic boundary conditions; nearest-neighbor
direction order ``(+x, +y, -x, -y)`` and next-nearest
``(+x+y, -x+y, -x-y, +x-y)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# nearest-neighbor displacement order: +x, +y, -x, -y
NN_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))
# next-nearest order: +x+y, -x+y, -x-y, +x-y
NNN_DIRS = ((1, 1), (-1, 1), (-1, -1), (1, -1))


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static (hashable) lattice shape.

    Requires Lx, Ly ≥ 3: on L=2 tori the +x/−x (+y/−y) neighbors coincide
    and the additive scatter in bdg.py would double-count those bonds.
    """

    Lx: int
    Ly: int

    def __post_init__(self):
        if self.Lx < 3 or self.Ly < 3:
            raise ValueError(
                f"LatticeSpec requires Lx, Ly >= 3 (got {self.Lx}x{self.Ly});"
                " L=2 tori have double bonds that the additive BdG scatter"
                " counts differently from the reference")

    @property
    def n_sites(self) -> int:
        return self.Lx * self.Ly

    @property
    def dim(self) -> int:
        """BdG matrix dimension 2N."""
        return 2 * self.Lx * self.Ly


def site_index(x: np.ndarray, y: np.ndarray, Lx: int, Ly: int) -> np.ndarray:
    """Periodic site index i = y*Lx + x (0-based)."""
    return (np.mod(y, Ly)) * Lx + np.mod(x, Lx)


@functools.lru_cache(maxsize=None)
def neighbor_tables(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """(nn, nnn) int32 tables of shape (N, 4)."""
    xs = np.arange(lat.Lx)
    ys = np.arange(lat.Ly)
    X, Y = np.meshgrid(xs, ys, indexing="xy")  # Y slow, X fast -> i = y*Lx + x
    X = X.reshape(-1)
    Y = Y.reshape(-1)

    def table(dirs):
        cols = [site_index(X + dx, Y + dy, lat.Lx, lat.Ly) for dx, dy in dirs]
        return np.stack(cols, axis=1).astype(np.int32)

    return table(NN_DIRS), table(NNN_DIRS)


@functools.lru_cache(maxsize=None)
def site_coords(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) integer coordinates of every site, shape (N,)."""
    i = np.arange(lat.n_sites)
    return i % lat.Lx, i // lat.Lx


@functools.lru_cache(maxsize=None)
def antinodal_phases(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """±1 phase vectors exp(i k·r) for k=(π,0) and k=(0,π), with the
    reference's 1-based parity convention: +1 where the 1-based coordinate
    is even, i.e. ``(-1)^(x_0based+1)``."""
    x, y = site_coords(lat)
    phase_pi0 = np.where((x + 1) % 2 == 0, 1.0, -1.0)
    phase_0pi = np.where((y + 1) % 2 == 0, 1.0, -1.0)
    return phase_pi0, phase_0pi


@functools.lru_cache(maxsize=None)
def k_grid(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """FFT-ordered momentum grids kx (Lx,), ky (Ly,) in [0, 2π)."""
    kx = 2.0 * np.pi * np.arange(lat.Lx) / lat.Lx
    ky = 2.0 * np.pi * np.arange(lat.Ly) / lat.Ly
    return kx, ky


def dispersion(kx, ky, t, tp, mu):
    """ε_k = −2t(cos kx + cos ky) − 4t' cos kx cos ky − μ."""
    return -2.0 * t * (np.cos(kx) + np.cos(ky)) - 4.0 * tp * np.cos(kx) * np.cos(ky) - mu
