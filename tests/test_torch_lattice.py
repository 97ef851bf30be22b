"""Port parity: lattice tables, static index constants and spectral grids
of dwavehmc_tpu_torch equal the JAX package's exactly."""

import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bdg as jbdg
from dwavehmc_tpu.models import bdg_real as jbdg_real
from dwavehmc_tpu.models import lattice as jlat
from dwavehmc_tpu.models import params as jparams
from dwavehmc_tpu.models import transport as jtransport
from dwavehmc_tpu.models import transport_real as jtransport_real
from dwavehmc_tpu_torch.models import bdg as tbdg
from dwavehmc_tpu_torch.models import bdg_real as tbdg_real
from dwavehmc_tpu_torch.models import lattice as tlat
from dwavehmc_tpu_torch.models import params as tparams
from dwavehmc_tpu_torch.models import transport as ttransport
from dwavehmc_tpu_torch.models import transport_real as ttransport_real

torch.set_num_threads(2)

SHAPES = [(3, 3), (4, 4), (4, 6), (5, 3)]


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape", SHAPES)
def test_lattice_tables_equal(shape):
    jl, tl = jlat.LatticeSpec(*shape), tlat.LatticeSpec(*shape)
    assert (tl.n_sites, tl.dim) == (jl.n_sites, jl.dim)
    for fn in ("neighbor_tables", "site_coords", "antinodal_phases",
               "k_grid"):
        _equal(getattr(tlat, fn)(tl), getattr(jlat, fn)(jl))
    kx, ky = jlat.k_grid(jl)
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    _equal(tlat.dispersion(KX, KY, 1.0, -0.35, -1.08),
           jlat.dispersion(KX, KY, 1.0, -0.35, -1.08))


@pytest.mark.parametrize("shape", SHAPES)
def test_static_index_constants_equal(shape):
    jl, tl = jlat.LatticeSpec(*shape), tlat.LatticeSpec(*shape)
    _equal(tbdg.adjacency(tl), jbdg.adjacency(jl))
    _equal(tbdg.pairing_scatter_indices(tl), jbdg.pairing_scatter_indices(jl))
    _equal(tbdg_real.embedding_scatter_indices(tl),
           jbdg_real.embedding_scatter_indices(jl))
    _equal(ttransport.current_patterns(tl), jtransport.current_patterns(jl))
    _equal(ttransport_real.dft_matrices(shape[0]),
           jtransport_real.dft_matrices(shape[0]))


def test_lattice_rejects_two_site_torus():
    with pytest.raises(ValueError):
        tlat.LatticeSpec(2, 4)


@pytest.mark.parametrize("eta,domega,omega_max",
                         [(0.01, 0.002, 4.0), (8 / 576, 0.2 * 8 / 576, 4.0),
                          (0.15, 0.1, 1.2)])
def test_spectral_spec_grids_equal(eta, domega, omega_max):
    js = jparams.SpectralSpec(eta=eta, domega=domega, omega_max=omega_max)
    ts = tparams.SpectralSpec(eta=eta, domega=domega, omega_max=omega_max)
    assert ts.n_omega == js.n_omega and ts.omega_min == js.omega_min
    _equal(ts.omega_grid(), js.omega_grid())
    _equal(ts.dos_grid(), js.dos_grid())


def test_production_grid_size():
    """The 24×24 production grid (η = 8/N, Δω = 0.2η, ω_max = 4) has
    1436 frequencies."""
    eta = 8.0 / 576
    assert tparams.SpectralSpec(eta=eta, domega=0.2 * eta).n_omega == 1436
