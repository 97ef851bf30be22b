"""The port's CUDA kernels against their plain versions, on the card.

Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Each test needs a CUDA device and skips without one (the decision is made
in the fixture, at run time).
"""

import math

import pytest
import torch

from dwavehmc_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def _rot_inputs(batch, n, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(batch, n, n, generator=g)
    b = torch.randn(batch, n, n, generator=g)
    d = torch.sort(torch.randn(batch, n, generator=g), dim=-1).values * 3.0
    tr = (a + a.mT) * 0.01
    ti = (b - b.mT) * 0.01
    return tr.to(device), ti.to(device), d.to(device)


@pytest.mark.parametrize("batch,n", [(2, 300), (3, 1152), (1, 1)])
def test_rotation_kernel_matches_plain(cuda, batch, n):
    tr, ti, d = _rot_inputs(batch, n, cuda)
    tr[0, 0, min(1, n - 1)] = 0.0
    ti[0, 0, min(1, n - 1)] = 0.0
    before = kernels.LAUNCHES["rotation_s_parts"]
    sr, si = kernels.rotation_s_parts(tr, ti, d, 0.1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rotation_s_parts"] == before + 1
    pr, pi = kernels.rotation_s_parts_plain(tr, ti, d, 0.1)
    assert float((sr - pr).abs().max()) <= 1e-6
    assert float((si - pi).abs().max()) <= 1e-6
    assert float(sr.diagonal(dim1=-2, dim2=-1).abs().max()) == 0.0


@pytest.mark.parametrize("batch,n_w,M", [(1, 37, 1000), (2, 1, 70000),
                                         (2, 1436, 50000), (1, 5, 0)])
def test_lorentzian_kernel_matches_plain(cuda, batch, n_w, M):
    g = torch.Generator(device="cpu").manual_seed(1)
    omega = torch.linspace(0.0 if n_w == 1 else 0.01, 4.0, n_w).expand(
        batch, n_w).contiguous()
    de = torch.randn(batch, M, generator=g) * 2.0
    w2 = torch.rand(batch, M, generator=g)
    omega, de, w2 = (x.to(cuda) for x in (omega, de, w2))
    before = kernels.LAUNCHES["weighted_lorentzian_sum"]
    got = kernels.weighted_lorentzian_sum(omega, de, w2, 0.05)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 1
    want = kernels.weighted_lorentzian_sum_plain(omega, de, w2, 0.05)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    again = kernels.weighted_lorentzian_sum(omega, de, w2, 0.05)
    assert torch.equal(got, again)            # no atomics: bit-identical


def test_lorentzian_single_peak(cuda):
    omega = torch.linspace(0.0, 2.0, 21, device=cuda)[None]
    de = torch.ones((1, 1), device=cuda)
    w2 = torch.full((1, 1), 2.0, device=cuda)
    got = kernels.weighted_lorentzian_sum(omega, de, w2, 0.2)
    x = omega - 1.0
    want = 2.0 * (0.2 / math.pi) / (x * x + 0.04)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


def test_launchers_check_their_inputs(cuda):
    tr, ti, d = _rot_inputs(1, 8, cuda)
    with pytest.raises(TypeError):
        kernels.rotation_s_parts_cuda(tr.double(), ti, d, 0.1)
    with pytest.raises(ValueError):
        kernels.rotation_s_parts_cuda(tr.mT, ti, d, 0.1)
    with pytest.raises(ValueError):
        kernels.weighted_lorentzian_sum_cuda(d, d, d[:, :4].contiguous(), 0.1)


@pytest.mark.parametrize("L", [4, 11, 12])
def test_exact_anchor_eigenvalues_reach_float32_accuracy(cuda, L):
    """The exact anchor's float32 eigenvalues on the card are as good as the
    CPU's, on both sides of the 512-dimension switch in
    ``diagonalize_embedding``."""
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, diagonalize_embedding, static_embedding)
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params

    lat = LatticeSpec(L, L)
    g = torch.Generator().manual_seed(L)
    p = make_params(W=1.0, dtype=torch.float64, device="cpu")
    dis = (torch.rand(2, lat.n_sites, generator=g, dtype=torch.float64)
           < 0.05).double()
    dre, dim = (0.1 * (torch.rand(2, lat.n_sites, 2, generator=g,
                                  dtype=torch.float64) - 0.5)
                for _ in range(2))
    M = assemble_embedding(lat, static_embedding(lat, p.t, p.tp, p.mu, dis),
                           dre, dim)
    want = torch.linalg.eigvalsh(M)[..., ::2]
    cpu32 = diagonalize_embedding(M.float())[0].double()
    got = diagonalize_embedding(M.float().to(cuda))[0].double().cpu()
    cpu_err = float((cpu32 - want).abs().max())
    assert float((got - want).abs().max()) <= max(2.0 * cpu_err, 2e-5)
