"""Port parity for the clean-limit oracle and the clean start, float64 on
the CPU: ``models/bcs.py`` against the JAX package's (1e-12 relative), the
k-space gap equation against the real-space Δ ← J·P iteration on the port's
complex path (1e-8), ``init_delta``/``uniform_dwave_delta`` against the JAX
layout, and ``from_complex_state``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bcs as jbcs
from dwavehmc_tpu.models import params as jparams
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.sampler import hmc_real as jhmc_real
from dwavehmc_tpu_torch.models import bcs as tbcs
from dwavehmc_tpu_torch.models.bdg import (
    assemble_bdg,
    diagonalize,
    static_hamiltonian,
)
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import (
    init_delta,
    make_params,
    uniform_dwave_delta,
)
from dwavehmc_tpu_torch.ops.forces import pairing_correlations
from dwavehmc_tpu_torch.sampler.hmc_real import (
    draw_init_state,
    from_complex_state,
)
from dwavehmc_tpu_torch.utils.carry import state_from_numpy

torch.set_num_threads(2)

BAND = dict(t=1.0, tp=-0.35, mu=-1.08)


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("L,beta,J", [(8, 100.0, 1.6), (10, 180.0, 1.6),
                                      (8, 5000.0, 0.8)])
def test_gap_equation_matches_jax(L, beta, J):
    args = (BAND["t"], BAND["tp"], BAND["mu"], beta, J)
    for delta in (1e-3, 0.05, 0.2, 0.35):
        want = jbcs.bcs_gap_rhs(delta, JLat(L, L), *args)
        got = tbcs.bcs_gap_rhs(delta, TLat(L, L), *args)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    want = jbcs.bcs_selfconsistent_gap(JLat(L, L), *args)
    got = tbcs.bcs_selfconsistent_gap(TLat(L, L), *args)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # at J = 0.8 the 8×8 grid has no gap: the iteration runs to zero
    assert (got > 0.05) == (J > 1.0)


def test_gap_equation_guard_takes_the_limit():
    """At Δ = 0 the k-grid holds points with ε_k = 0 on a g = 0 line only
    for a tuned μ: there E_k = 0 and the term is the limit β g²/4 (= 0), not
    NaN."""
    lat = TLat(4, 4)
    mu = -2.0 * BAND["t"] * (1.0 + 1.0) - 4.0 * BAND["tp"]   # ε(0, 0) = 0
    rhs = tbcs.bcs_gap_rhs(0.0, lat, BAND["t"], BAND["tp"], mu, 50.0, 1.6)
    assert np.isfinite(rhs)
    want = jbcs.bcs_gap_rhs(0.0, JLat(4, 4), BAND["t"], BAND["tp"], mu,
                            50.0, 1.6)
    assert rhs == want


def test_bcs_rhs_fixed_point_matches_real_space_mean_field():
    """The k-space gap equation and the real-space Δ ← J·P iteration on the
    port's complex path agree in the clean limit (two independent routes
    to the same mean-field gap), as the JAX package's test holds them."""
    lat = TLat(8, 8)
    beta, J = 100.0, 1.6
    gap_k = tbcs.bcs_selfconsistent_gap(lat, BAND["t"], BAND["tp"],
                                        BAND["mu"], beta, J)
    p = make_params(**BAND, beta=beta, J=J, dtype=torch.float64,
                    device="cpu")
    Hs = static_hamiltonian(lat, p.t, p.tp, p.mu,
                            torch.zeros((1, lat.n_sites), dtype=torch.float64))
    d = uniform_dwave_delta(lat, 0.15, dtype=torch.float64, device="cpu")
    for _ in range(800):
        e, u = diagonalize(assemble_bdg(lat, Hs, d))
        nd = J * pairing_correlations(lat, e, u, p.beta)
        done = float(torch.amax(torch.abs(nd - d))) < 1e-13
        d = nd
        if done:
            break
    gap_r = float(torch.abs(torch.mean(0.5 * (d[0, :, 0] - d[0, :, 1]))))
    np.testing.assert_allclose(gap_r, gap_k, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_dwave_delta_matches_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = np.asarray(jparams.uniform_dwave_delta(JLat(5, 4), 0.3, jdt))
    got = uniform_dwave_delta(TLat(5, 4), 0.3, n_chains=2, dtype=dtype,
                              device="cpu")
    assert got.dtype == (torch.complex64 if dtype == torch.float32
                         else torch.complex128)
    assert got.shape == (2, 20, 2)
    for c in range(2):
        np.testing.assert_array_equal(_np(got[c]), want)


@pytest.mark.parametrize("scale", [0.1, 0.5])
def test_init_delta_matches_jax_on_its_draws(scale):
    """The JAX draws (real parts, then imaginary parts) given to the port
    give the JAX start bit for bit; drawn from a generator, the start is
    the one the real-path init draws from the same seed."""
    lat_j, lat_t = JLat(4, 5), TLat(4, 5)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = np.stack([np.asarray(jparams.init_delta(k, lat_j, scale,
                                                   jnp.float64))
                     for k in keys])
    u = np.stack([np.asarray(jax.random.uniform(k, (2, 20, 2),
                                                dtype=jnp.float64))
                  for k in keys])
    got = init_delta(lat_t, 2, uniforms=u, scale=scale, dtype=torch.float64,
                     device="cpu")
    np.testing.assert_array_equal(_np(got), want)

    d = init_delta(lat_t, 3, generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64, device="cpu")
    assert d.shape == (3, 20, 2) and d.dtype == torch.complex128
    assert float(torch.abs(d.real).max()) <= 0.05
    p = make_params(n_imp=0.0, dtype=torch.float64, device="cpu")
    _, dre, dim = draw_init_state(
        lat_t, p, 3, generator=torch.Generator().manual_seed(5),
        disorder=torch.zeros((3, 20), dtype=torch.float64),
        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(_np(dre), _np(d.real))
    np.testing.assert_array_equal(_np(dim), _np(d.imag))
    with pytest.raises(ValueError, match="generator= or uniforms="):
        init_delta(lat_t, 1, device="cpu")


def test_from_complex_state_matches_jax():
    """The JAX complex ensemble, carried into the port, converts to the
    real-pair layout exactly as JAX's ``from_complex_state`` converts it,
    and back."""
    jlat = JLat(4, 4)
    jp = jparams.make_params(W=0.5, n_imp=0.25, beta=10.0, dtype=jnp.float64)
    js = jens.init_ensemble(jlat, jp, jax.random.PRNGKey(1), 2,
                            dtype=jnp.float64, n_imp=0.25)
    js = js._replace(pi=js.delta * (0.3 - 0.7j))
    want = jax.vmap(jhmc_real.from_complex_state)(js)
    ts = state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                          device="cpu")
    got = from_complex_state(ts)
    assert set(got._fields) == set(want._fields) - {"key"}
    for name in got._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(
        _np(torch.complex(got.X, got.Y)), _np(ts.evecs))
    np.testing.assert_array_equal(
        _np(torch.complex(got.pi_re, got.pi_im)), _np(ts.pi))
