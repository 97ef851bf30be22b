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


@pytest.mark.parametrize("batch,n", [(2, 300), (3, 1152), (1, 1),
                                     (1, 2048)])
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


@pytest.mark.parametrize("batch,n_w,M,eta", [(1, 37, 1000, 0.05),
                                             (2, 1, 70000, 0.05),
                                             (2, 1436, 50000, 0.05),
                                             (1, 5, 0, 0.05),
                                             (2, 100, 4194304, 8 / 1024)])
def test_lorentzian_kernel_matches_plain(cuda, batch, n_w, M, eta):
    """At BASELINE config 5's 4.19M pairs (η = 8/N, N = 1024) the float32
    plain version's own rounding reaches a few 1e-4 relative, so there the
    kernel is held against the plain version in float64."""
    g = torch.Generator(device="cpu").manual_seed(1)
    omega = torch.linspace(0.0 if n_w == 1 else 0.01, 4.0, n_w).expand(
        batch, n_w).contiguous()
    de = torch.randn(batch, M, generator=g) * 2.0
    w2 = torch.rand(batch, M, generator=g)
    omega, de, w2 = (x.to(cuda) for x in (omega, de, w2))
    before = kernels.LAUNCHES["weighted_lorentzian_sum"]
    got = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 1
    ref = torch.float64 if M >= 2 ** 22 else torch.float32
    want = kernels.weighted_lorentzian_sum_plain(
        *(x.to(ref) for x in (omega, de, w2)), eta).float()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    again = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
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


def test_tf32_scope_and_the_three_pass_product(cuda):
    """Inside ``matmul_precision`` a float32 product is a TF32 one: "default"
    takes it as is (its error against float64 past 10× the IEEE
    product's); "high"'s three-pass product stays within 8× the IEEE
    error.  TF32 is off again after the scope, also when its body
    raises."""
    from dwavehmc_tpu_torch.utils.precision import matmul_precision, product

    g = torch.Generator(device="cpu").manual_seed(3)
    a, b = (torch.randn(512, 512, generator=g).to(cuda) for _ in range(2))
    want = a.double() @ b.double()
    ieee = a @ b
    with matmul_precision("default", cuda):
        assert torch.backends.cuda.matmul.allow_tf32
        one = product("default")(a, b)
    with matmul_precision("high", cuda):
        three = product("high")(a, b)
    assert not torch.backends.cuda.matmul.allow_tf32
    err = {name: float((x.double() - want).abs().max())
           for name, x in (("ieee", ieee), ("one", one), ("three", three))}
    assert err["one"] > 10.0 * err["ieee"], err
    assert err["three"] <= 8.0 * err["ieee"], err
    assert not torch.equal(three, ieee)
    with pytest.raises(RuntimeError):
        with matmul_precision("high", cuda):
            raise RuntimeError("inside the scope")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(a @ b, ieee)


@pytest.mark.parametrize("L", [12, 16])
def test_guarded_ph_anchor_with_the_lift_at_high(cuda, L):
    """``lift_precision="high"`` (three TF32 passes) on the card: no
    fallback, eigenvalues within 10× the "highest" lift's error (or
    1e-5·‖M‖∞), orthonormality to the float32 bound."""
    from dwavehmc_tpu_torch.ops.ph_eigh import diagonalize_embedding_ph_guarded

    M = _ph_embedding(L, L)
    want = torch.linalg.eigvalsh(M)[..., ::2]
    errs = {}
    for prec in ("highest", "high"):
        w, X, Y, fb = diagonalize_embedding_ph_guarded(
            M.float().to(cuda), lift_precision=prec)
        assert fb is False
        errs[prec] = float((w.double().cpu() - want).abs().max())
        gram = X.mT @ X + Y.mT @ Y
        assert float((gram - torch.eye(gram.shape[-1], device=cuda)).abs()
                     .max()) <= 5e-4
    assert not torch.backends.cuda.matmul.allow_tf32
    assert errs["high"] <= max(10.0 * errs["highest"],
                               1e-5 * float(M.abs().sum(-1).max())), errs


@pytest.mark.parametrize("polish", ["highest", "high"])
def test_bf16_rotations_then_the_endpoint_polish_on_the_card(cuda, polish):
    """``tracked_leapfrog``'s fast configuration on the card: 6 rotations
    with bfloat16 storage (exp2, one Newton–Schulz step), the basis back in
    float32, then the endpoint's 6 float32 refine rotations and 3 polish
    rotations at ``polish`` with a "highest" readout: one K1 launch per
    rotation, and the eigenvalues as close to float64 ``eigvalsh`` as the
    CPU's run of the same steps (or 2e-5)."""
    from dwavehmc_tpu_torch.ops.tracked_eigh import tracked_eigh_nofallback

    hr, hi, ur0, ui0 = _tracked_problem(6, 3, 11, 1e-3)
    M = torch.cat([torch.cat([hr, -hi], -1), torch.cat([hi, hr], -1)], -2)
    want = torch.linalg.eigvalsh(M)[..., ::2]

    def run(dev):
        h_r, h_i, u_r, u_i = (x.float().to(dev) for x in (hr, hi, ur0, ui0))
        _, u_r, u_i, _ = tracked_eigh_nofallback(
            h_r, h_i, u_r, u_i, n_iter=6, ns_steps=1,
            rot_dtype=torch.bfloat16, rot_scheme="exp2")
        assert u_r.dtype == u_i.dtype == torch.float32
        _, u_r, u_i, _ = tracked_eigh_nofallback(h_r, h_i, u_r, u_i,
                                                 n_iter=6, rot_scheme="exp2")
        d, _, _, _ = tracked_eigh_nofallback(
            h_r, h_i, u_r, u_i, n_iter=3, precision=polish,
            eval_precision="highest", rot_scheme="exp2")
        return torch.sort(d.double().cpu(), dim=-1).values

    before = kernels.LAUNCHES["rotation_s_parts"]
    got = run(cuda)
    assert kernels.LAUNCHES["rotation_s_parts"] == before + 15
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu_err = float((run("cpu") - want).abs().max())
    err = float((got - want).abs().max())
    assert err <= max(4.0 * cpu_err, 2e-5), (err, cpu_err)


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


def test_demo_32x32_on_the_card(cuda):
    """``demo_32x32`` at 8×8 (bf16 rotations, its other defaults cut to 2
    therm and 2 × 2 measured sweeps): finite, both kernels launched, K2 on
    the narrow geometry (94 frequencies)."""
    from dwavehmc_tpu_torch.drivers import demo_32x32 as demo

    kn = dict(demo.knobs({}), L=8, therm=2, sweeps=2)
    before = dict(kernels.LAUNCHES)
    out, _, _ = demo.demo(kn, "cuda", log=lambda s: None)
    assert out["finite"]
    assert out["device"] == torch.cuda.get_device_name(cuda)
    assert kernels.LAUNCHES["rotation_s_parts"] > before["rotation_s_parts"]
    assert (kernels.LAUNCHES["weighted_lorentzian_sum"]
            == before["weighted_lorentzian_sum"] + 2)
    assert kernels._lorentzian_launch(94, 128 ** 2).R == 1


def test_spectra_parity_function_on_the_card_at_12x12(cuda):
    """``spectra_parity_production``'s per-chain comparison at 12×12 on a
    seeded random Δ and disorder: the card's float32 production leg (K2
    twice) within the script's tolerances of the float64 oracle on the CPU;
    the card's own oracle, float64 on K2's plain sums with no K2 launch,
    within 1e-9 of the CPU's, relative to each observable's peak."""
    import numpy as np

    from dwavehmc_tpu_torch.drivers import spectra_parity_production as spp
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec

    rng = np.random.default_rng(12)
    lat = LatticeSpec(12, 12)
    N = lat.n_sites
    delta = (0.2 * rng.uniform(0.5, 1.5, (N, 2))
             * np.exp(2j * np.pi * rng.uniform(size=(N, 2))))
    disorder = np.zeros(N, np.float32)
    disorder[rng.permutation(N)[:round(0.05 * N)]] = 1.0
    spec = spp.production_spec(lat)
    args = (lat, spec, delta.astype(np.complex64), disorder,
            1.0 / spp.T_POINT)
    before = kernels.LAUNCHES["weighted_lorentzian_sum"]
    prod = spp.production_leg(*args, "cuda")
    assert kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 2
    cpu = spp.oracle_leg(*args, "cpu")
    row = spp.compare(prod, cpu)
    assert row["eigh_evals"]["max_abs"] <= (
        spp.TOL_EV * row["eigh_evals"]["scale"])
    for k in spp.OBSERVABLES:
        assert row[k]["rel_to_peak"] <= spp.TOL_REL, (k, row[k])
    before = kernels.LAUNCHES["weighted_lorentzian_sum"]
    card = spp.oracle_leg(*args, "cuda")
    assert kernels.LAUNCHES["weighted_lorentzian_sum"] == before
    for k in spp.OBSERVABLES:
        assert spp.diff(card[1][k], cpu[1][k])["rel_to_peak"] <= 1e-9, k
    for k, rel in cpu[2].items():
        assert abs(card[2][k] - rel) <= 1e-4, k


def test_bench_forces_formulations_agree_on_the_card(cuda):
    """``bench_forces``' equivalence in float32 on the card (16×16, 4
    chains of an ``init_ensemble`` ensemble): the row contraction and the
    matmul-diagonal ρ within the script's 1e-4."""
    from dwavehmc_tpu_torch.drivers import bench_forces as bf
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.parallel.ensemble import init_ensemble

    lat = LatticeSpec(16, 16)
    params = make_params(W=1.0, n_imp=0.05, beta=bf.BETA, J=0.8,
                         dtype=torch.float32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(bf.SEED)
    st = init_ensemble(lat, params, gen, 4, dtype=torch.float32, n_imp=0.05,
                       device=cuda)
    diff, tol = bf.equivalence(lat, st.evals, st.evecs, params.beta)
    assert tol == 1e-4 and diff < tol, diff


def _randn(shape, dtype, cuda, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(
        cuda, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,m", [(1, 1), (3, 7), (8, 1152), (5, 2048),
                                    (1152, 300), (2, 16384), (2, 16385),
                                    (3, 16562), (2, 40000)])
def test_chain_sum_kernel_is_bit_equal_to_plain(cuda, dtype, rows, m):
    x = _randn((rows, m), dtype, cuda, m)
    before = kernels.LAUNCHES["chain_sum"]
    got = kernels.chain_sum(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chain_sum"] == before + 1
    assert got.dtype == dtype and got.shape == (rows,)
    assert torch.equal(got, kernels.chain_sum_plain(x))
    k = max(1, rows // 2)
    assert torch.equal(kernels.chain_sum(x[:k]), got[:k])


# rows longer than 4096 fold their upper levels as they load (46×46: n =
# 4232); float64 at 8464 (92×92) with one chain, where the plain version's
# padded products take gigabytes
@pytest.mark.parametrize("dtype,B,n", [
    (dtype, B, n) for B, n in ((1, 1), (3, 5), (8, 1152), (2, 2048),
                               (1, 4096))
    for dtype in (torch.float32, torch.float64)] + [
    (torch.float32, 1, 4097), (torch.float32, 2, 4232),
    (torch.float32, 2, 4608), (torch.float64, 1, 8464)])
def test_chain_matvec_kernel_is_bit_equal_to_plain(cuda, dtype, B, n):
    args = tuple(_randn(s, dtype, cuda, i) for i, s in enumerate(
        ((B, n, n), (B, n, n), (B, n), (B, n))))
    before = kernels.LAUNCHES["chain_matvec"]
    wr, wi = kernels.chain_matvec(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chain_matvec"] == before + 1
    pr, pi = kernels.chain_matvec_plain(*args)
    assert torch.equal(wr, pr) and torch.equal(wi, pi)
    k = max(1, B // 2)
    ar, ai = kernels.chain_matvec(*(x[:k] for x in args))
    assert torch.equal(ar, wr[:k]) and torch.equal(ai, wi[:k])


def test_chain_launchers_check_their_inputs(cuda):
    """Wrong dtypes and CPU tensors raise; rows past one block's register
    tree (16384 for K3, 4096 for K4) are added in the plain version's
    order."""
    x = _randn((2, 8), torch.float32, cuda, 0)
    with pytest.raises(TypeError):
        kernels.chain_sum_cuda(x.half())
    with pytest.raises(ValueError):
        kernels.chain_sum_cuda(x.cpu())
    long = _randn((1, 16385), torch.float32, cuda, 1)
    assert torch.equal(kernels.chain_sum_cuda(long),
                       kernels.chain_sum_plain(long))
    a = _randn((1, 4097, 4097), torch.float32, cuda, 1)
    v = _randn((1, 4097), torch.float32, cuda, 2)
    got = kernels.chain_matvec_cuda(a, a, v, v)
    want = kernels.chain_matvec_plain(a, a, v, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_sweep_reductions_are_batch_invariant_on_the_card(cuda, dtype):
    """The σ-cap's estimate and the HMC energies give 2 chains alone the
    bits they get in a batch of 8 (ROADMAP fault F6)."""
    from dwavehmc_tpu_torch.ops.tracked_eigh import _spectral_norm_est
    from dwavehmc_tpu_torch.sampler.hmc_real import _energy_terms

    a, b = _randn((8, 300, 300), dtype, cuda, 2), _randn((8, 300, 300),
                                                         dtype, cuda, 3)
    sr, si = (a - a.mT) * 0.1, (b + b.mT) * 0.1
    assert torch.equal(_spectral_norm_est(sr[:2], si[:2]),
                       _spectral_norm_est(sr, si)[:2])
    f = [_randn((8, 144, 2), dtype, cuda, s) for s in range(4, 8)]
    e = _randn((8, 288), dtype, cuda, 8)
    beta = torch.linspace(1.0, 20.0, 8, dtype=dtype, device=cuda)
    one = torch.tensor(1.0, dtype=dtype, device=cuda)
    whole = _energy_terms(*f, e, beta, one, one)
    alone = _energy_terms(*(x[:2] for x in f), e[:2], beta[:2], one, one)
    assert torch.equal(whole[:2], alone)


def test_guarded_ph_anchor_rescues_a_broken_chain_on_the_card(cuda,
                                                              monkeypatch):
    """A chain whose float32 CholeskyQR³ breaks down (made NaN, as it comes
    out on the card) is redone in float64; the batch does not fall back,
    the other chains keep the unrescued solve's bits, and the rescued
    chain's levels are as good as theirs (F5)."""
    from dwavehmc_tpu_torch.ops import ph_eigh

    M = torch.cat([_ph_embedding(12, s) for s in range(3)]).float().to(cuda)
    w_ref, X_ref, _ = ph_eigh.diagonalize_embedding_ph(M)
    real = ph_eigh.cholqr2

    def failing(Y, shift_first=True):
        Q = real(Y, shift_first)
        if Y.dtype == torch.float32 and Y.shape[0] == 3:
            Q = Q.clone()
            Q[1] = float("nan")
        return Q

    monkeypatch.setattr(ph_eigh, "cholqr2", failing)
    ph_eigh.reset_guard()
    w, X, _, fb = ph_eigh.diagonalize_embedding_ph_guarded(M)
    assert fb is False and ph_eigh.GUARD["rescued"] == 1
    assert torch.equal(w[[0, 2]], w_ref[[0, 2]])
    assert torch.equal(X[[0, 2]], X_ref[[0, 2]])
    w64 = torch.linalg.eigvalsh(M.double())[..., ::2]
    err = (w.double() - w64).abs().amax(-1)
    assert float(err[1]) <= float(err[[0, 2]].max())
