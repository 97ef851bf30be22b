"""Port parity for the untracked sweep and the PH-split anchor, float64 on
the CPU, L=4, replaying the JAX package's draws.

* ``hmc_sweep_real`` in both ``eigh_mode``s (exact eigh every step, or
  tracked steps with one exact re-anchor);
* ``run_segment_tracked(exact_solver="ph")``: K=1 over two sweeps and K=2
  over three (cheap, anchored, anchored), every anchor a guarded PH solve;
* ``init_ensemble_real(exact_solver="ph", init_chunk=2)`` on the JAX
  init's own disorder and Δ.

ΔH and accept decisions agree to 1e-10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.sampler import hmc_real as jhmc
from dwavehmc_tpu.sampler.hmc import calc_optimal_dt
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.ops import ph_eigh as tph
from dwavehmc_tpu_torch.parallel import ensemble as tens
from dwavehmc_tpu_torch.sampler import hmc_real as thmc
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
N = L * L
NT = 4
BETA = 10.0
TRACK = dict(tracked_iters=6, refine_iters=6, polish_iters=3, ns_steps=1,
             rot_scheme="exp2")


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


@pytest.fixture(scope="module")
def ensemble():
    jp = jmake_params(W=0.5, n_imp=0.25, beta=BETA, J=1.0, dtype=jnp.float64)
    js = jens.init_ensemble_real(JL, jp, jax.random.PRNGKey(5), 2,
                                 dtype=jnp.float64, n_imp=0.25,
                                 exact_solver="ph")
    return (jp, js, params_from_numpy(_as_np(jp), device="cpu"),
            state_from_numpy(_as_np(js), device="cpu"))


def _compare(tinfo, tnew, jinfo, jnew):
    np.testing.assert_array_equal(_np(tinfo.accepted),
                                  np.asarray(jinfo.accepted))
    for name in ("dH", "H_old", "H_new"):
        np.testing.assert_allclose(_np(getattr(tinfo, name)),
                                   np.asarray(getattr(jinfo, name)),
                                   atol=1e-10, err_msg=name)
    for name in ("delta_re", "delta_im", "pi_re", "pi_im", "evals"):
        np.testing.assert_allclose(_np(getattr(tnew, name)),
                                   np.asarray(getattr(jnew, name)),
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("mode", ["exact", "tracked"])
def test_hmc_sweep_real_matches_jax(ensemble, mode):
    jp, js, tp, ts = ensemble
    dt = calc_optimal_dt(BETA, 1.0, 1.0, NT)
    fn = functools.partial(jhmc.hmc_sweep_real, JL, jp, Nt=NT, dt=dt,
                           eigh_mode=mode)
    jnew, jinfo = jax.vmap(lambda s: fn(state=s))(js)
    normals, uniforms = jax_draws(js.key, 1)
    tnew, tinfo = thmc.hmc_sweep_real(TL, tp, ts, NT, dt, mode,
                                      normals=normals[0],
                                      uniforms=uniforms[0])
    _compare(tinfo, tnew, jinfo, jnew)


def test_run_segment_real_draws_from_generator(ensemble):
    """The segment runner repeats from one seed and records every sweep."""
    _, _, tp, ts = ensemble

    def run():
        g = torch.Generator().manual_seed(1)
        return tens.run_segment_real(TL, tp, ts, 2, 3, 0.05,
                                     eigh_mode="exact", generator=g)

    (s1, seg1), (s2, seg2) = run(), run()
    assert seg1.dH.shape == (2, 2) and seg1.observables.delta_amp.shape == (
        2, 2)
    assert torch.equal(seg1.dH, seg2.dH) and torch.equal(s1.X, s2.X)
    with pytest.raises(ValueError):
        thmc.hmc_sweep_real(TL, tp, ts, 1, 0.05, "bogus",
                            generator=torch.Generator())


@pytest.mark.parametrize("n_sweeps,K", [(2, 1), (3, 2)])
def test_tracked_segment_with_ph_anchor_matches_jax(ensemble, n_sweeps, K):
    jp, js, tp, ts = ensemble
    dt = calc_optimal_dt(BETA, 1.0, 1.0, NT)
    normals, uniforms = jax_draws(js.key, n_sweeps)
    jnew, jseg = jens.run_segment_tracked(JL, jp, js, n_sweeps, NT, dt,
                                          anchor_every=K, exact_solver="ph",
                                          **TRACK)
    tph.reset_guard()
    tnew, tseg = tens.run_segment_tracked(TL, tp, ts, n_sweeps, NT, dt,
                                          anchor_every=K, exact_solver="ph",
                                          normals=normals, uniforms=uniforms,
                                          **TRACK)
    # one guarded solve per exact anchor: one per block of K sweeps
    assert (tph.GUARD["solves"], tph.GUARD["fallbacks"]) == (
        -(-n_sweeps // K), 0)
    np.testing.assert_array_equal(_np(tseg.accepted),
                                  np.asarray(jseg.accepted))
    np.testing.assert_allclose(_np(tseg.dH), np.asarray(jseg.dH),
                               atol=1e-10)
    for name in ("delta_re", "delta_im", "evals"):
        np.testing.assert_allclose(_np(getattr(tnew, name)),
                                   np.asarray(getattr(jnew, name)),
                                   atol=1e-10, err_msg=name)


def test_init_ensemble_ph_with_chunks_matches_jax():
    jp = jmake_params(W=0.6, n_imp=0.25, beta=5.0, J=0.8, dtype=jnp.float64)
    js = jens.init_ensemble_real(JL, jp, jax.random.PRNGKey(11), 3,
                                 dtype=jnp.float64, n_imp=0.25,
                                 exact_solver="ph", init_chunk=2)
    tp = params_from_numpy(_as_np(jp), device="cpu")
    tph.reset_guard()
    ts = tens.init_ensemble_real(
        TL, tp, None, 3, dtype=torch.float64, exact_solver="ph",
        init_chunk=2, disorder=np.asarray(js.disorder),
        delta0_re=np.asarray(js.delta_re), delta0_im=np.asarray(js.delta_im),
        device="cpu")
    assert (tph.GUARD["solves"], tph.GUARD["fallbacks"]) == (2, 0)
    np.testing.assert_allclose(_np(ts.evals), np.asarray(js.evals),
                               atol=1e-10)
    # gauge-free: the negative-level density matrix, real part
    n = N

    def rho(X, Y):
        X, Y = np.asarray(X)[..., :n], np.asarray(Y)[..., :n]
        return X @ np.swapaxes(X, -1, -2) + Y @ np.swapaxes(Y, -1, -2)

    np.testing.assert_allclose(rho(_np(ts.X), _np(ts.Y)), rho(js.X, js.Y),
                               atol=1e-10)
