"""Port parity: the tracked eigensolver from the same (hr, hi, U₀) as the JAX
package, float64.  Both start from the same basis, so the gauge is fixed and
the bases themselves can be compared; eigenvalues are compared unsorted, as
both packages return them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bdg as jbdg
from dwavehmc_tpu.models import bdg_real as jbdg_real
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.ops import tracked_eigh as jte
from dwavehmc_tpu.parallel.ensemble import init_ensemble_real as jinit_ens
from dwavehmc_tpu_torch.ops import tracked_eigh as tte

torch.set_num_threads(2)

L = 4
JL = JLat(L, L)


def _np(x):
    return x.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def problem():
    """(hr, hi, ur0, ui0): H one leapfrog-sized step away from the carried
    exact eigenbasis U₀ — the tracked solver's operating point."""
    p = jmake_params(W=0.5, n_imp=0.25, beta=10.0, J=1.0, dtype=jnp.float64)
    s = jinit_ens(JL, p, jax.random.PRNGKey(2), 2, dtype=jnp.float64,
                  n_imp=0.25)
    rng = np.random.default_rng(0)
    dre = s.delta_re + 0.02 * rng.normal(size=s.delta_re.shape)
    dim = s.delta_im + 0.02 * rng.normal(size=s.delta_im.shape)
    Hs = jax.vmap(lambda d: jbdg.static_hamiltonian(JL, p.t, p.tp, p.mu, d))(
        s.disorder)
    hr, hi = jax.vmap(lambda H, a, b: jbdg_real.assemble_parts(JL, H, a, b))(
        Hs, jnp.asarray(dre), jnp.asarray(dim))
    return tuple(np.asarray(a) for a in (hr, hi, s.X, s.Y))


@pytest.mark.parametrize("precision", [None, "highest"])
def test_complex_products_match(precision):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 2, 24, 24))
    for fn_t, fn_j in ((tte.cmm, jte.cmm), (tte.cmm_dag, jte.cmm_dag)):
        want = jax.vmap(lambda x: fn_j(*x, precision=precision),
                        in_axes=1)(jnp.asarray(a))
        got = fn_t(*(_t(x) for x in a), precision=precision)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-12)


def test_projection_norm_and_newton_schulz_match(problem):
    hr, hi, ur, ui = problem
    want = jax.vmap(jte._project_T)(*(jnp.asarray(x) for x in problem))
    got = tte._project_T(*(_t(x) for x in problem))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-12)
    sr, si = jax.vmap(jte.rotation_matrix_parts)(*want[:3])
    np.testing.assert_allclose(
        _np(tte._spectral_norm_est(_t(sr), _t(si))),
        np.asarray(jax.vmap(jte._spectral_norm_est)(sr, si)), rtol=1e-12)
    for prec in (None, "highest"):
        want_u = jax.vmap(lambda a, b: jte._newton_schulz(a, b, prec))(
            jnp.asarray(ur) * 1.01, jnp.asarray(ui))
        got_u = tte._newton_schulz(_t(ur) * 1.01, _t(ui), prec)
        for g, w in zip(got_u, want_u):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-12)


@pytest.mark.parametrize("scheme,ns_steps", [("ns", 2), ("exp2", 1),
                                              ("exp2", 2)])
def test_tracked_step_matches(problem, scheme, ns_steps):
    want = jax.vmap(lambda *x: jte.tracked_step(
        *x, ns_steps=ns_steps, rot_scheme=scheme))(
        *(jnp.asarray(x) for x in problem))
    got = tte.tracked_step(*(_t(x) for x in problem), ns_steps=ns_steps,
                           rot_scheme=scheme)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-10)


def _rho(d, ur, ui, beta=10.0):
    f = 1.0 / (1.0 + np.exp(beta * d))
    re = np.einsum("bin,bn,bjn->bij", ur, f, ur) + np.einsum(
        "bin,bn,bjn->bij", ui, f, ui)
    im = np.einsum("bin,bn,bjn->bij", ui, f, ur) - np.einsum(
        "bin,bn,bjn->bij", ur, f, ui)
    return re, im


@pytest.mark.parametrize("kw", [
    dict(n_iter=6, ns_steps=1, rot_scheme="exp2"),
    dict(n_iter=6, ns_steps=2, rot_scheme="ns"),
    dict(n_iter=3, precision="highest", eval_precision="highest",
         eval_correction=True, rot_scheme="exp2"),
])
def test_tracked_eigh_nofallback_matches(problem, kw):
    want = jax.vmap(lambda *x: jte.tracked_eigh_nofallback(*x, **kw))(
        *(jnp.asarray(x) for x in problem))
    got = tte.tracked_eigh_nofallback(*(_t(x) for x in problem), **kw)
    jd, jur, jui, jres = (np.asarray(a) for a in want)
    td, tur, tui, tres = (_np(a) for a in got)
    np.testing.assert_allclose(td, jd, atol=1e-9)          # unsorted, as is
    for a, b in zip(_rho(td, tur, tui), _rho(jd, jur, jui)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_allclose(tres, jres, atol=1e-9)


def test_rayleigh_correction_matches(problem):
    tr, ti, d, _ = jax.vmap(jte._project_T)(*(jnp.asarray(x) for x in problem))
    want = jax.vmap(jte.rayleigh_corrected_evals)(tr, ti, d)
    got = tte.rayleigh_corrected_evals(_t(tr), _t(ti), _t(d))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-12)


def test_bf16_rotations_keep_carry_dtype(problem):
    """rot_dtype=bfloat16: operands in bf16, S built in float32, basis cast
    back to the carry dtype; the readout stays near the float64 one."""
    ref = tte.tracked_eigh_nofallback(*(_t(x) for x in problem), n_iter=2)
    got = tte.tracked_eigh_nofallback(*(_t(x) for x in problem), n_iter=2,
                                      rot_dtype=torch.bfloat16)
    assert got[1].dtype == torch.float64 and got[0].dtype == torch.float64
    assert float((got[0] - ref[0]).abs().max()) < 0.1
