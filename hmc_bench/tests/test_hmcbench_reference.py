"""The float64 reference against the port on the CPU at a tiny lattice:
the same equations give the same numbers."""

import pytest
import torch

from hmc_bench import harness
from hmc_bench.reference import physics as ref

L = 6
C = {"t": 1.0, "tp": -0.35, "mu": -1.08, "beta": 10.0, "J": 0.8,
     "mass": 1.0}
F64 = torch.float64


@pytest.fixture
def port():
    from dwavehmc_tpu_torch.models.params import make_params

    return make_params(W=1.0, n_imp=0.1, dtype=F64, device="cpu", **C)


@pytest.fixture
def state():
    g = torch.Generator().manual_seed(7)
    N = L * L
    disorder = (torch.rand((3, N), generator=g, dtype=F64) < 0.1).to(F64)
    dre = 0.3 * torch.randn((3, N, 2), generator=g, dtype=F64)
    dim = 0.3 * torch.randn((3, N, 2), generator=g, dtype=F64)
    return disorder, dre, dim


def port_eigs(port, disorder, dre, dim):
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, diagonalize_embedding, static_embedding)
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec

    lat = LatticeSpec(L, L)
    M = assemble_embedding(lat, static_embedding(
        lat, port.t, port.tp, port.mu, disorder), dre, dim)
    return diagonalize_embedding(M)


def test_hamiltonian_matches_the_port(port, state):
    from dwavehmc_tpu_torch.models.bdg import assemble_bdg, static_hamiltonian
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec

    disorder, dre, dim = state
    lat = LatticeSpec(L, L)
    H_port = assemble_bdg(lat, static_hamiltonian(
        lat, port.t, port.tp, port.mu, disorder), torch.complex(dre, dim))
    H = ref.hamiltonian(L, L, C, disorder, torch.complex(dre, dim))
    assert torch.allclose(H, H_port, atol=1e-14)


def test_spectrum_and_forces_match_the_port(port, state):
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.ops.forces_real import hmc_forces_real

    disorder, dre, dim = state
    delta = torch.complex(dre, dim)
    E, U = ref.eigh(ref.hamiltonian(L, L, C, disorder, delta))
    e, X, Y = port_eigs(port, disorder, dre, dim)
    assert torch.allclose(E, e, atol=1e-11)
    Fr, Fi, _, _ = hmc_forces_real(LatticeSpec(L, L), dre, dim, e, X, Y,
                                   port.beta, port.J)
    F = ref.force(L, L, delta, E, U, C)
    assert torch.allclose(F, torch.complex(Fr, Fi), atol=1e-10)


def test_trajectory_and_dH_match_the_port(port, state):
    """One untracked exact-eigh sweep of the port (the same leapfrog) on
    the same normals."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.sampler.hmc_real import (
        HMCStateReal, hmc_sweep_real)

    disorder, dre, dim = state
    e, X, Y = port_eigs(port, disorder, dre, dim)
    s = HMCStateReal(dre, dim, dre * 0, dim * 0, disorder, e, X, Y)
    g = torch.Generator().manual_seed(3)
    normals = torch.randn((3, 2, L * L, 2), generator=g, dtype=F64)
    u = torch.rand((3,), generator=g)
    dt = harness.optimal_dt(C["beta"], C["J"], C["mass"], 4)
    s1, info = hmc_sweep_real(LatticeSpec(L, L), port, s, 4, dt,
                              eigh_mode="exact", normals=normals,
                              uniforms=u)
    delta = torch.complex(dre, dim)
    E, U = ref.eigh(ref.hamiltonian(L, L, C, disorder, delta))
    pi0, d1, pi1, E1, U1 = ref.leapfrog(L, L, C, disorder, delta, E, U,
                                        normals, 4, dt)
    dH = ref.delta_H(C, pi0, pi1, delta, d1, E, E1)
    assert torch.allclose(dH, info.dH, atol=1e-9)
    assert torch.equal(ref.accepts(dH, u), info.accepted)
    moved = info.accepted[:, None, None]
    assert torch.allclose(torch.where(moved, d1, delta),
                          torch.complex(s1.delta_re, s1.delta_im),
                          atol=1e-12)


@pytest.mark.parametrize("cell", ["dwave16_b8.fast"])
def test_a_tiny_run_agrees_with_the_reference(tiny, cell):
    """The whole run on the CPU, every chain and period compared: the
    gaps are those of the tracked float32 path, far under the cells'
    limits."""
    from hmc_bench import check

    c = tiny(cell)
    run = harness.run_cell(c, 2**31 + 5, 1.0, False, "cpu")
    v = check.readings(c, run, 2**31 + 5, "cpu")
    assert v["sampled"]["chains"] == [0, 1, 2, 3]
    assert run.failed == v["nonfinite"] == 0
    assert v["dH_gap"] < 0.2 and v["delta_gap"] < 0.02
    assert v["evals_gap"] < 1e-4 and v["init_evals_gap"] < 1e-5
    assert v["flips"] == 0
