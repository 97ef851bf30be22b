"""Port parity: parameters, disorder, BdG assembly (both layouts) and the
exact embedding eigh, held against the JAX package in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bdg as jbdg
from dwavehmc_tpu.models import bdg_real as jbdg_real
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.models.params import sample_disorder as jsample_disorder
from dwavehmc_tpu.ops.spectral import fermi_factors as jfermi
from dwavehmc_tpu.sampler.hmc import calc_optimal_dt as jdt
from dwavehmc_tpu.sampler.hmc_real import _energy_terms as jenergy
from dwavehmc_tpu.sampler.hmc_real import init_chain_state_real as jinit
from dwavehmc_tpu_torch.models import bdg as tbdg
from dwavehmc_tpu_torch.models import bdg_real as tbdg_real
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import make_params, sample_disorder
from dwavehmc_tpu_torch.ops.spectral import fermi_factors
from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt
from dwavehmc_tpu_torch.sampler.hmc_real import (
    _energy_terms,
    _finite_or_zero,
    init_chain_state_real,
)

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
N = L * L
B = 2
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=0.5, n_imp=0.25, J=0.8, mass=1.0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.detach().cpu().numpy()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    disorder = np.where(rng.uniform(size=(B, N)) < 0.25, 0.5, 0.0)
    dre = 0.1 * (rng.uniform(size=(B, N, 2)) - 0.5)
    dim = 0.1 * (rng.uniform(size=(B, N, 2)) - 0.5)
    return disorder, dre, dim


def _params(beta=3.0):
    return (jmake_params(beta=beta, dtype=jnp.float64, **PHYS),
            make_params(beta=beta, dtype=torch.float64, device="cpu", **PHYS))


def test_sample_disorder_with_injected_permutation():
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = np.stack([np.asarray(jsample_disorder(k, JL, 0.5, 0.25,
                                                 dtype=jnp.float64))
                     for k in keys])
    perm = np.stack([np.asarray(jax.random.permutation(k, N)) for k in keys])
    got = sample_disorder(TL, 0.5, 0.25, B, perm=perm, dtype=torch.float64,
                          device="cpu")
    np.testing.assert_array_equal(_np(got), want)
    g = torch.Generator().manual_seed(0)
    drawn = sample_disorder(TL, 0.5, 0.25, B, generator=g, device="cpu")
    assert drawn.shape == (B, N)
    assert (drawn == 0.5).sum(dim=1).tolist() == [4, 4]


def test_static_parts_and_assembly_match():
    disorder, dre, dim = _inputs()
    jp, tp = _params()
    jHs = jax.vmap(lambda d: jbdg.static_hamiltonian(
        JL, jp.t, jp.tp, jp.mu, d))(jnp.asarray(disorder))
    tHs = tbdg.static_hamiltonian(TL, tp.t, tp.tp, tp.mu, _t(disorder))
    np.testing.assert_allclose(_np(tHs), np.asarray(jHs), atol=1e-12)

    jMs = jax.vmap(lambda d: jbdg_real.static_embedding(
        JL, jp.t, jp.tp, jp.mu, d))(jnp.asarray(disorder))
    tMs = tbdg_real.static_embedding(TL, tp.t, tp.tp, tp.mu, _t(disorder))
    np.testing.assert_allclose(_np(tMs), np.asarray(jMs), atol=1e-12)

    jM = jax.vmap(lambda M, a, b: jbdg_real.assemble_embedding(JL, M, a, b))(
        jMs, jnp.asarray(dre), jnp.asarray(dim))
    tM = tbdg_real.assemble_embedding(TL, tMs, _t(dre), _t(dim))
    np.testing.assert_allclose(_np(tM), np.asarray(jM), atol=1e-12)

    jhr, jhi = jax.vmap(lambda H, a, b: jbdg_real.assemble_parts(JL, H, a, b))(
        jHs, jnp.asarray(dre), jnp.asarray(dim))
    thr, thi = tbdg_real.assemble_parts(TL, tHs, _t(dre), _t(dim))
    np.testing.assert_allclose(_np(thr), np.asarray(jhr), atol=1e-12)
    np.testing.assert_allclose(_np(thi), np.asarray(jhi), atol=1e-12)


def test_per_chain_beta_broadcasts_in_assembly():
    disorder, _, _ = _inputs(1)
    mu = make_params(mu=[-1.0, -0.5], dtype=torch.float64, device="cpu").mu
    Hs = tbdg.static_hamiltonian(TL, torch.tensor(1.0, dtype=torch.float64),
                                 torch.tensor(-0.35, dtype=torch.float64),
                                 mu, _t(disorder))
    for b, m in enumerate((-1.0, -0.5)):
        one = tbdg.static_hamiltonian(
            TL, torch.tensor(1.0, dtype=torch.float64),
            torch.tensor(-0.35, dtype=torch.float64),
            torch.tensor(m, dtype=torch.float64), _t(disorder[b:b + 1]))
        np.testing.assert_array_equal(_np(Hs[b]), _np(one[0]))


def _rho(evals, X, Y, beta):
    """Gauge-invariant one-body density U f U† as (real, imag)."""
    f = 1.0 / (1.0 + np.exp(beta * evals))
    re = np.einsum("bin,bn,bjn->bij", X, f, X) + np.einsum(
        "bin,bn,bjn->bij", Y, f, Y)
    im = np.einsum("bin,bn,bjn->bij", Y, f, X) - np.einsum(
        "bin,bn,bjn->bij", X, f, Y)
    return re, im


def test_diagonalize_embedding_matches_gauge_invariantly():
    disorder, dre, dim = _inputs(2)
    jp, tp = _params()
    jM = jax.vmap(lambda d, a, b: jbdg_real.assemble_embedding(
        JL, jbdg_real.static_embedding(JL, jp.t, jp.tp, jp.mu, d), a, b))(
        jnp.asarray(disorder), jnp.asarray(dre), jnp.asarray(dim))
    je, jX, jY = (np.asarray(a) for a in
                  jax.vmap(jbdg_real.diagonalize_embedding)(jM))
    te, tX, tY = (_np(a) for a in
                  tbdg_real.diagonalize_embedding(_t(np.asarray(jM))))
    np.testing.assert_allclose(te, je, atol=1e-10)
    for a, b in zip(_rho(te, tX, tY, 3.0), _rho(je, jX, jY, 3.0)):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_init_chain_state_with_injected_draws():
    disorder, dre, dim = _inputs(3)
    jp, tp = _params()
    js = jax.vmap(lambda d, a, b: jinit(
        JL, jp, jax.random.PRNGKey(0), dtype=jnp.float64, delta0_re=a,
        delta0_im=b, disorder=d))(jnp.asarray(disorder), jnp.asarray(dre),
                                  jnp.asarray(dim))
    ts = init_chain_state_real(TL, tp, B, dtype=torch.float64,
                               delta0_re=dre, delta0_im=dim,
                               disorder=disorder, device="cpu")
    np.testing.assert_allclose(_np(ts.evals), np.asarray(js.evals),
                               atol=1e-10)
    np.testing.assert_array_equal(_np(ts.pi_re), 0.0)
    g = torch.Generator().manual_seed(1)
    drawn = init_chain_state_real(TL, tp, B, generator=g, n_imp=0.25,
                                  device="cpu")
    assert drawn.X.shape == (B, 2 * N, 2 * N)
    assert float(drawn.delta_re.abs().max()) <= 0.05


def test_spectral_pieces_match():
    rng = np.random.default_rng(4)
    evals = rng.normal(size=(B, 2 * N))
    beta = np.array([3.0, 40.0])
    want = jax.vmap(jfermi)(jnp.asarray(evals), jnp.asarray(beta))
    np.testing.assert_allclose(_np(fermi_factors(_t(evals), _t(beta))),
                               np.asarray(want), rtol=1e-14)
    for b, J, m, nt in ((10.0, 0.8, 1.0, 6), (1e4, 1.0, 2.0, 20)):
        assert calc_optimal_dt(b, J, m, nt) == jdt(b, J, m, nt)
    # energy terms: softplus form equals jax.nn.softplus
    dre, dim = rng.normal(size=(2, B, N, 2))
    pre, pim = rng.normal(size=(2, B, N, 2))
    want = jax.vmap(lambda a, b_, c, d, e, bt: jenergy(a, b_, c, d, e, bt,
                                                       0.8, 1.0))(
        *(jnp.asarray(x) for x in (dre, dim, pre, pim, evals, beta)))
    got = _energy_terms(*(_t(x) for x in (dre, dim, pre, pim, evals, beta)),
                        torch.tensor(0.8, dtype=torch.float64),
                        torch.tensor(1.0, dtype=torch.float64))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-13)
    x = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    assert _finite_or_zero(x).tolist() == [1.0, 0.0, 0.0, 0.0]


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_params()
