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


def test_rotation_kernel_returns_the_callers_dtype(cuda):
    """A float64 carry (the tracked path in float64 on the card) gets the
    float32 kernel's result in float64, as JAX promotes it."""
    tr, ti, d = (x.double() for x in _rot_inputs(2, 72, cuda))
    sr, si = kernels.rotation_s_parts(tr, ti, d, 0.1)
    assert sr.dtype == si.dtype == torch.float64
    kr, ki = kernels.rotation_s_parts(tr.float(), ti.float(), d.float(), 0.1)
    assert torch.equal(sr, kr.double()) and torch.equal(si, ki.double())


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


def _signed_pairs(betas, n_levels, seed=2):
    """(de, w2) of σ(ω) as ``models/transport.optical_conductivity`` builds
    them: a ±-symmetric sorted spectrum, Fermi factors at ``betas``, a random
    symmetric nonnegative |J|²; float32 (B, n_levels²)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(betas)
    e = torch.randn(B, n_levels // 2, generator=g, dtype=torch.float64)
    E = torch.sort(torch.cat([-e.abs(), e.abs()], -1) * 1.5, -1).values
    f = torch.sigmoid(-torch.tensor(betas, dtype=torch.float64)[:, None] * E)
    a = torch.rand(B, n_levels, n_levels, generator=g, dtype=torch.float64)
    J2 = 0.5 * (a + a.mT)
    de = (E[:, None, :] - E[:, :, None]).reshape(B, -1)
    w2 = ((f[:, :, None] - f[:, None, :]) * J2).reshape(B, -1)
    return de.float(), w2.float()


def test_lorentzian_signed_weights_against_float64(cuda):
    """The σ(ω) path's signed, partly cancelling weights at (2, 1436, 50000):
    the kernel's error relative to max |S| per chain is at most 4× the
    float32 plain version's, or 1e-5."""
    de, w2 = (x[:, :50000].to(cuda) for x in _signed_pairs([1e4, 0.5], 224))
    eta = 8.0 / 576
    omega = (eta + torch.arange(1436, dtype=torch.float32, device=cuda)
             * (0.2 * eta)).expand(2, -1).contiguous()
    got = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
    plain32 = kernels.weighted_lorentzian_sum_plain(omega, de, w2, eta)
    want = kernels.weighted_lorentzian_sum_plain(
        omega.double(), de.double(), w2.double(), eta)
    scale = want.abs().amax(-1)

    def err(s):
        return float(((s.double() - want).abs().amax(-1) / scale).max())

    assert err(got) <= max(4.0 * err(plain32), 1e-5)


@pytest.mark.parametrize("eta,de_scale,w_scale", [(1e-12, 2.0, 1.0),
                                                  (0.05, 1e10, 1.0),
                                                  (0.05, 2.0, 1e19)])
def test_lorentzian_out_of_range_inputs(cuda, eta, de_scale, w_scale):
    """A tiny η, a huge |de| or a huge |w2| takes the kernel off the
    two-pair fraction, whose product a·b would leave the normal floats; the
    sum still matches the plain version."""
    g = torch.Generator(device="cpu").manual_seed(3)
    omega = torch.linspace(0.01, 4.0, 300)[None].expand(2, -1).contiguous()
    de = torch.randn(2, 9000, generator=g) * de_scale
    w2 = (torch.rand(2, 9000, generator=g) - 0.3) * w_scale
    omega, de, w2 = (x.to(cuda) for x in (omega, de, w2))
    got = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
    want = kernels.weighted_lorentzian_sum_plain(
        omega.double(), de.double(), w2.double(), eta)
    assert bool(torch.isfinite(got).all())
    scale = want.abs().amax(-1, keepdim=True)
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-5


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


def _ph_embedding(L, seed, gapless=False):
    """(1, 4N, 4N) float64 CPU embedding: disorder and a random Δ, or the
    clean gapless lattice (t′ = 0, μ = 0, Δ = 0)."""
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, static_embedding)
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params

    lat = LatticeSpec(L, L)
    g = torch.Generator().manual_seed(seed)
    p = make_params(tp=0.0 if gapless else -0.35, mu=0.0 if gapless else -1.08,
                    dtype=torch.float64, device="cpu")
    N = lat.n_sites
    dis = torch.zeros(1, N, dtype=torch.float64)
    dre = torch.zeros(1, N, 2, dtype=torch.float64)
    dim = torch.zeros_like(dre)
    if not gapless:
        dis = (torch.rand(1, N, generator=g, dtype=torch.float64)
               < 0.05).double()
        dre, dim = (0.1 * (torch.rand(1, N, 2, generator=g,
                                      dtype=torch.float64) - 0.5)
                    for _ in range(2))
    return assemble_embedding(lat, static_embedding(lat, p.t, p.tp, p.mu,
                                                    dis), dre, dim)


@pytest.mark.parametrize("L", [6, 12, 16, 17])
def test_guarded_ph_anchor_reaches_float32_accuracy(cuda, L):
    """The guarded PH solve in float32 on the card, either side of the
    512-dimension switch of its half-dimension eigh (2N = 72 … 578): no
    fallback, eigenvalues as good as float32 ``eigh``'s on the CPU."""
    from dwavehmc_tpu_torch.ops.ph_eigh import diagonalize_embedding_ph_guarded

    M = _ph_embedding(L, L)
    want = torch.linalg.eigvalsh(M)[..., ::2]
    cpu_err = float((torch.linalg.eigvalsh(M.float())[..., ::2].double()
                     - want).abs().max())
    w, X, Y, fb = diagonalize_embedding_ph_guarded(M.float().to(cuda))
    assert fb is False
    err = float((w.double().cpu() - want).abs().max())
    assert err <= max(4.0 * cpu_err, 1e-5 * float(M.abs().sum(-1).max()))
    # orthonormality to the JAX package's own float32 bound
    # (tests/test_ph_eigh.py)
    gram = X.mT @ X + Y.mT @ Y
    assert float((gram - torch.eye(gram.shape[-1], device=cuda)).abs()
                 .max()) <= 5e-4


def test_guarded_ph_anchor_falls_back_on_the_card(cuda):
    from dwavehmc_tpu_torch.models.bdg_real import diagonalize_embedding
    from dwavehmc_tpu_torch.ops.ph_eigh import diagonalize_embedding_ph_guarded

    M = torch.cat([_ph_embedding(4, 1), _ph_embedding(4, 0, gapless=True)])
    M = M.float().to(cuda)
    w, X, Y, fb = diagonalize_embedding_ph_guarded(M)
    w0, X0, Y0 = diagonalize_embedding(M)
    assert fb is True
    assert torch.equal(w, w0) and torch.equal(X, X0) and torch.equal(Y, Y0)


def _bdg_complex(L, seed):
    """(1, 2N, 2N) complex128 CPU BdG matrix: disorder and a random Δ."""
    from dwavehmc_tpu_torch.models.bdg import assemble_bdg, static_hamiltonian
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params

    lat = LatticeSpec(L, L)
    g = torch.Generator().manual_seed(seed)
    p = make_params(dtype=torch.float64, device="cpu")
    N = lat.n_sites
    dis = (torch.rand(1, N, generator=g, dtype=torch.float64) < 0.05).double()
    dre, dim = (0.1 * (torch.rand(1, N, 2, generator=g, dtype=torch.float64)
                       - 0.5) for _ in range(2))
    return assemble_bdg(lat, static_hamiltonian(lat, p.t, p.tp, p.mu, dis),
                        torch.complex(dre, dim))


@pytest.mark.parametrize("L", [4, 11, 12, 16, 17])
def test_complex_eigh_reaches_single_precision_accuracy(cuda, L):
    """The complex path's eigh of a complex64 Hermitian matrix on the card
    (``ops/eigh.eigh_complex``, dimension 2N = 32 … 578, either side of the
    512-dimension switch of ``models/bdg_real.symmetric_eigh``): eigenvalues
    as good as complex64 ``eigh``'s on the CPU, orthonormal vectors."""
    from dwavehmc_tpu_torch.ops.eigh import eigh_complex

    H = _bdg_complex(L, L)
    want = torch.linalg.eigvalsh(H)
    cpu_err = float((torch.linalg.eigvalsh(H.to(torch.complex64)).double()
                     - want).abs().max())
    w, U = eigh_complex(H.to(torch.complex64).to(cuda))
    assert w.dtype == torch.float32 and U.dtype == torch.complex64
    assert float((w.double().cpu() - want).abs().max()) <= max(
        2.0 * cpu_err, 2e-5)
    eye = torch.eye(U.shape[-1], dtype=U.dtype, device=cuda)
    assert float((U.mH @ U - eye).abs().max()) <= 1e-4


def test_complex_transport_launches_k2_twice_and_matches_plain(
        cuda, monkeypatch):
    """``measure_transport_and_spectra`` on the card: two K2 launches (σ_DC
    and σ(ω)), and the result of the same call with K2's plain version on
    the same CUDA tensors — equal everywhere but in the two conductivities,
    which agree to 1e-4 of their largest magnitude."""
    from dwavehmc_tpu_torch.models import transport as ttr
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import SpectralSpec, make_params
    from dwavehmc_tpu_torch.parallel.ensemble import init_ensemble

    lat = LatticeSpec(6, 6)
    spec = SpectralSpec(eta=8.0 / 36, domega=1.6 / 36, omega_max=4.0)
    p = make_params(beta=[3.0, 30.0], W=1.0, J=0.8, device=cuda)
    s = init_ensemble(lat, p, torch.Generator(device=cuda).manual_seed(0), 2,
                      n_imp=0.05, device=cuda)
    before = kernels.LAUNCHES["weighted_lorentzian_sum"]
    got = ttr.measure_transport_and_spectra(lat, spec, p, s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 2
    monkeypatch.setattr(ttr, "weighted_lorentzian_sum",
                        kernels.weighted_lorentzian_sum_plain)
    plain = ttr.measure_transport_and_spectra(lat, spec, p, s)
    assert kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 2
    for name in got._fields:
        a, b = getattr(got, name), getattr(plain, name)
        assert bool(torch.isfinite(a).all()), name
        if name in ("dc_conductivity", "optical_conductivity"):
            assert float((a - b).abs().max()) <= 1e-4 * float(
                b.abs().max()), name
        else:
            assert torch.equal(a, b), name


def _tracked_problem(L, B, seed, move):
    """(hr, hi, ur0, ui0) float64 on the CPU: B disordered chains at a
    random Δ, H moved by ``move`` in Δ away from the exact eigenbasis U₀."""
    from dwavehmc_tpu_torch.models.bdg import static_hamiltonian
    from dwavehmc_tpu_torch.models.bdg_real import assemble_parts
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import init_delta, make_params
    from dwavehmc_tpu_torch.ops.tracked_eigh import full_eigh_from_parts

    lat = LatticeSpec(L, L)
    g = torch.Generator().manual_seed(seed)
    p = make_params(dtype=torch.float64, device="cpu")
    dis = (torch.rand(B, lat.n_sites, generator=g, dtype=torch.float64)
           < 0.05).double()
    d = init_delta(lat, B, generator=g, scale=0.4, dtype=torch.float64,
                   device="cpu")
    Hs = static_hamiltonian(lat, p.t, p.tp, p.mu, dis)
    _, ur0, ui0 = full_eigh_from_parts(*assemble_parts(lat, Hs, d.real,
                                                       d.imag))
    d = d + move * torch.randn(d.shape, generator=g, dtype=torch.complex128)
    hr, hi = assemble_parts(lat, Hs, d.real, d.imag)
    return hr, hi, ur0, ui0


@pytest.mark.parametrize("cold", [False, True])
def test_tracked_eigh_on_the_card_matches_the_cpu(cuda, cold):
    """``tracked_eigh`` in float32 on the card: n_iter K1 launches, the
    CPU's fallback decisions (none from the exact basis of a nearby state;
    every chain from the identity), and eigenvalues and orthonormality as
    close to the CPU's float64 run as the CPU's own float32 run is (or 2e-5
    and 1e-4)."""
    from dwavehmc_tpu_torch.ops.tracked_eigh import tracked_eigh

    hr, hi, ur0, ui0 = _tracked_problem(6, 3, 11, 1e-3)
    if cold:
        ur0 = torch.eye(hr.shape[-1], dtype=hr.dtype).expand_as(hr)
        ui0 = torch.zeros_like(hr)
    want = tracked_eigh(hr, hi, ur0, ui0)
    cpu32 = tracked_eigh(*(x.float() for x in (hr, hi, ur0, ui0)))
    before = kernels.LAUNCHES["rotation_s_parts"]
    got = tracked_eigh(*(x.float().to(cuda) for x in (hr, hi, ur0, ui0)))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rotation_s_parts"] == before + 3
    assert got[3].tolist() == want[3].tolist() == cpu32[3].tolist() == [cold] * 3
    cpu_err = float((cpu32[0].double() - want[0]).abs().max())
    err = float((got[0].double().cpu() - want[0]).abs().max())
    assert err <= max(4.0 * cpu_err, 2e-5), (err, cpu_err)

    def orth(ur, ui):
        U = torch.complex(ur, ui).to(torch.complex128)
        eye = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
        return float((U.mH @ U - eye).abs().max())

    # the fallback keeps V[..., ::2] of a float32 eigh (fault F0): its basis
    # is held to the CPU's float32 orthonormality, not to a fixed bound
    assert orth(got[1], got[2]) <= max(4.0 * orth(cpu32[1], cpu32[2]), 1e-4)


def test_clean_benchmark_gate_passes_on_the_card(capsys):
    """S3 ``--fast`` on the card, float64 complex path: the gap equation
    holds to < 0.02 and the measurement acceptance is above 0.5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dwavehmc_tpu_torch.drivers import benchmark_clean

    res = benchmark_clean.benchmark(benchmark_clean.parser().parse_args(
        ["--fast", "--device", "cuda"]), log=lambda s: None)
    assert res["passed"] and res["diff"] < 0.02, res["diff"]
    assert res["acceptance"] > 0.5, res["acceptance"]
