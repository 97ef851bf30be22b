"""Port parity for the complex path, float64 on the CPU, L=4: BdG assembly,
both eigh variants, forces, the HMC energy, one ``hmc_sweep`` with the JAX
package's draws replayed, and the light observables — on a disordered
random-Δ state, and on the clean uniform d-wave state, whose spectrum is
degenerate (the case the real path cannot be held to, ROADMAP fault F0).
Eigenvectors are compared through gauge-invariant quantities only
(ρ = U f U†, forces, observables).  Tolerance 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bdg as jbdg
from dwavehmc_tpu.models import observables as jobs
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.models.params import uniform_dwave_delta
from dwavehmc_tpu.ops import eigh as jeigh
from dwavehmc_tpu.ops import forces as jforces
from dwavehmc_tpu.ops import spectral as jspec
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.sampler import hmc as jhmc
from dwavehmc_tpu_torch.models import bdg as tbdg
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.observables import measure_observables
from dwavehmc_tpu_torch.ops import forces as tforces
from dwavehmc_tpu_torch.ops import spectral as tspec
from dwavehmc_tpu_torch.parallel import ensemble as tens
from dwavehmc_tpu_torch.sampler import hmc as thmc
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
N = L * L
NT = 4
BETA = 10.0
TOL = dict(rtol=1e-10, atol=1e-10)


def _np(x):
    return x.detach().cpu().numpy()


def _as_np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def jax_draws(keys, n_sweeps):
    """Replay the per-sweep (key', k_mom, k_acc) splits of the JAX sweeps:
    normals (n_sweeps, B, 2, N, 2), uniforms (n_sweeps, B)."""
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        normals.append(jax.vmap(lambda k: jax.random.normal(
            k, (2, N, 2), jnp.float64))(ks[:, 1]))
        uniforms.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32))(ks[:, 2]))
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


def _rho(evals, evecs, beta):
    """ρ = U diag(f) U† per chain (numpy), gauge-invariant."""
    f = 1.0 / (1.0 + np.exp(beta * np.asarray(evals)))
    U = np.asarray(evecs)
    return (U * f[..., None, :]) @ np.conj(np.swapaxes(U, -1, -2))


def _jax_state(kind):
    """(JAX params, JAX ensemble) of two disordered random-Δ chains, or of
    one clean chain at the uniform d-wave Δ = (0.2, −0.2)."""
    if kind == "disordered":
        jp = jmake_params(W=0.5, n_imp=0.25, beta=BETA, J=1.0,
                          dtype=jnp.float64)
        return jp, jens.init_ensemble(JL, jp, jax.random.PRNGKey(7), 2,
                                      dtype=jnp.float64, n_imp=0.25)
    jp = jmake_params(W=0.0, n_imp=0.0, beta=BETA, J=1.0, dtype=jnp.float64)
    return jp, jens.init_ensemble(
        JL, jp, jax.random.PRNGKey(8), 1, dtype=jnp.float64, n_imp=0.0,
        delta0=uniform_dwave_delta(JL, 0.2, jnp.float64))


@pytest.fixture(scope="module", params=["disordered", "degenerate"])
def ensemble(request):
    jp, js = _jax_state(request.param)
    return (request.param, jp, js, params_from_numpy(_as_np(jp), device="cpu"),
            state_from_numpy(_as_np(js), device="cpu"))


def test_degenerate_state_is_degenerate(ensemble):
    kind, _, js, _, _ = ensemble
    gaps = np.diff(np.asarray(js.evals), axis=-1)
    if kind == "degenerate":
        assert (gaps < 1e-10).sum() > 4          # many degenerate levels
        assert np.abs(np.asarray(js.evals)).min() > 1e-3   # none at zero
    else:
        assert gaps.min() > 1e-6


def test_init_assembly_and_both_eigh_impls(ensemble, monkeypatch):
    """The port's init (on the JAX init's disorder and Δ) and its
    assembly reproduce the JAX matrix exactly; both eigh variants give its
    spectrum and density matrix."""
    kind, jp, js, tp, ts = ensemble
    H_j = jax.vmap(lambda d, dl: jbdg.assemble_bdg(
        JL, jbdg.static_hamiltonian(JL, jp.t, jp.tp, jp.mu, d), dl))(
            js.disorder, js.delta)
    H_t = tbdg.assemble_bdg(TL, tbdg.static_hamiltonian(
        TL, tp.t, tp.tp, tp.mu, ts.disorder), ts.delta)
    np.testing.assert_array_equal(_np(H_t), np.asarray(H_j))
    init = tens.init_ensemble(TL, tp, None, ts.delta.shape[0],
                              dtype=torch.float64,
                              disorder=_np(ts.disorder),
                              delta0=_np(ts.delta), device="cpu")
    np.testing.assert_allclose(_np(init.evals), np.asarray(js.evals), **TOL)
    rho_j = _rho(js.evals, js.evecs, BETA)
    for impl in ("complex", "real_embedding"):
        w_j, U_j = jax.vmap(jeigh.get_eigh(impl))(H_j)
        monkeypatch.setenv("DWAVEHMC_EIGH_IMPL", impl)
        w_t, U_t = tbdg.diagonalize(H_t)
        np.testing.assert_allclose(_np(w_t), np.asarray(w_j), **TOL)
        if kind == "disordered" or impl == "complex":
            # the embedding's pick of one vector per doubled level loses
            # partners in a degenerate subspace (F0): ρ only when simple
            np.testing.assert_allclose(_rho(_np(w_t), _np(U_t), BETA),
                                       rho_j, **TOL)
        np.testing.assert_allclose(
            np.linalg.norm(_np(U_t), axis=-2), 1.0, atol=1e-12)


def test_forces_and_energy(ensemble):
    _, jp, js, tp, ts = ensemble
    F_j, P_j = jax.vmap(lambda d, e, U: jforces.hmc_forces(
        JL, d, e, U, jp.beta, jp.J))(js.delta, js.evals, js.evecs)
    F_t, P_t = tforces.hmc_forces(TL, ts.delta, ts.evals, ts.evecs, tp.beta,
                                  tp.J)
    np.testing.assert_allclose(_np(F_t), np.asarray(F_j), **TOL)
    np.testing.assert_allclose(_np(P_t), np.asarray(P_j), **TOL)

    rng = np.random.default_rng(3)
    pi = rng.normal(size=js.delta.shape) + 1j * rng.normal(
        size=js.delta.shape)
    d_n = np.asarray(js.delta) + 0.01 * pi
    e_n = np.asarray(js.evals) * 1.001
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    H_j = jax.vmap(lambda d, p, e: jspec.total_energy(
        d, p, e, jp.beta, jp.J, jp.mass))(js.delta, jnp.asarray(pi), js.evals)
    H_t = tspec.total_energy(ts.delta, t(pi), ts.evals, tp.beta, tp.J,
                             tp.mass)
    np.testing.assert_allclose(_np(H_t), np.asarray(H_j), **TOL)
    dH_j = jax.vmap(lambda dn, pn, en, do, eo: jspec.energy_difference(
        dn, pn, en, do, pn, eo, jp.beta, jp.J, jp.mass))(
            jnp.asarray(d_n), jnp.asarray(0.9 * pi), jnp.asarray(e_n),
            js.delta, js.evals)
    dH_t = tspec.energy_difference(t(d_n), t(0.9 * pi), t(e_n), ts.delta,
                                   t(0.9 * pi), ts.evals, tp.beta, tp.J,
                                   tp.mass)
    np.testing.assert_allclose(_np(dH_t), np.asarray(dH_j), **TOL)


def test_hmc_sweep_matches_jax(ensemble):
    _, jp, js, tp, ts = ensemble
    dt = jhmc.calc_optimal_dt(BETA, 1.0, 1.0, NT)
    jnew, jinfo = jens.ensemble_sweep(JL, jp, js, NT, dt)
    normals, uniforms = jax_draws(js.key, 1)
    tnew, tinfo = thmc.hmc_sweep(TL, tp, ts, NT, dt, normals=normals[0],
                                 uniforms=uniforms[0])
    np.testing.assert_array_equal(_np(tinfo.accepted),
                                  np.asarray(jinfo.accepted))
    for name in ("dH", "H_old", "H_new"):
        np.testing.assert_allclose(_np(getattr(tinfo, name)),
                                   np.asarray(getattr(jinfo, name)),
                                   err_msg=name, **TOL)
    for name in ("delta", "pi", "evals"):
        np.testing.assert_allclose(_np(getattr(tnew, name)),
                                   np.asarray(getattr(jnew, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(_rho(_np(tnew.evals), _np(tnew.evecs), BETA),
                               _rho(jnew.evals, jnew.evecs, BETA), **TOL)


def test_measure_observables_matches_jax(ensemble):
    _, jp, js, tp, ts = ensemble
    want = jax.vmap(lambda s: jobs.measure_observables(JL, jp, s))(js)
    got = measure_observables(TL, tp, ts)
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


def test_segment_draws_from_generator_and_rejects_nan(ensemble):
    """The segment repeats from one seed; a diverged trajectory (NaN Δ) is
    rejected and leaves the state as it was."""
    _, _, _, tp, ts = ensemble

    def run():
        g = torch.Generator().manual_seed(2)
        return tens.run_segment(TL, tp, ts, 2, 3, 0.05, generator=g)

    (s1, seg1), (s2, seg2) = run(), run()
    B = ts.delta.shape[0]
    assert seg1.dH.shape == (2, B) and seg1.observables.hole_conc.shape == (
        2, B)
    assert torch.equal(seg1.dH, seg2.dH) and torch.equal(s1.delta, s2.delta)
    bad_dt = torch.full((B,), float("nan"), dtype=torch.float64)
    new, info = thmc.hmc_sweep(TL, tp, ts, 2, bad_dt,
                               generator=torch.Generator().manual_seed(0))
    assert not bool(info.accepted.any())
    assert torch.equal(new.delta, ts.delta) and torch.equal(new.evals,
                                                            ts.evals)


def test_complex_and_real_paths_agree_on_a_sweep():
    """The same disordered state (the real path is not held to degenerate
    spectra, F0) and draws through the complex ``hmc_sweep`` and the
    untracked real-pair ``hmc_sweep_real`` (exact eigh every step): the two
    paths integrate the same equations, so ΔH and the endpoint agree."""
    from dwavehmc_tpu_torch.sampler.hmc_real import hmc_sweep_real

    jp, js = _jax_state("disordered")
    tp = params_from_numpy(_as_np(jp), device="cpu")
    ts = state_from_numpy(_as_np(js), device="cpu")
    real = tens.init_ensemble_real(
        TL, tp, None, 2, dtype=torch.float64, exact_solver="qdwh",
        disorder=ts.disorder, delta0_re=ts.delta.real,
        delta0_im=ts.delta.imag, device="cpu")
    normals, uniforms = jax_draws(js.key, 1)
    dt = jhmc.calc_optimal_dt(BETA, 1.0, 1.0, NT)
    cnew, cinfo = thmc.hmc_sweep(TL, tp, ts, NT, dt, normals=normals[0],
                                 uniforms=uniforms[0])
    rnew, rinfo = hmc_sweep_real(TL, tp, real, NT, dt, "exact",
                                 normals=normals[0], uniforms=uniforms[0])
    np.testing.assert_allclose(_np(rinfo.dH), _np(cinfo.dH), **TOL)
    np.testing.assert_array_equal(_np(rinfo.accepted), _np(cinfo.accepted))
    np.testing.assert_allclose(_np(rnew.delta_re), _np(cnew.delta.real),
                               **TOL)
    np.testing.assert_allclose(_np(rnew.evals), _np(cnew.evals), **TOL)
