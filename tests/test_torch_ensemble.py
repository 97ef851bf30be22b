"""The slice as a whole: the port's ``run_segment_tracked`` and transport
against the JAX package's, float64, L=4, two chains.

Both packages start from the same state, carried over with
``utils/carry.py``; the JAX run's momentum and accept draws are replayed
from its per-chain key splits (key → key', k_mom, k_acc every sweep).  One
segment with K=1 (two sweeps, every sweep exactly anchored), then one with
K=2 over three sweeps (cheap, anchored, anchored — the short last block
still ends on an exact anchor).  Tolerances: accept decisions equal, dH and
fields to 1e-8, observables and transport to 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import SpectralSpec as JSpec
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.sampler.hmc import calc_optimal_dt
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import SpectralSpec as TSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.parallel import ensemble as tens
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
N = L * L
NT = 4
BETA = 10.0
SPEC = dict(eta=0.15, domega=0.1, omega_max=1.2)
TRACK = dict(tracked_iters=6, refine_iters=6, polish_iters=3, ns_steps=1,
             rot_scheme="exp2")


def _np(x):
    return x.detach().cpu().numpy()


def jax_segment_draws(keys, n_sweeps):
    """Replay ``tracked_leapfrog``'s draws for ``n_sweeps`` sweeps."""
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        normals.append(jax.vmap(lambda k: jax.random.normal(
            k, (2, N, 2), jnp.float64))(ks[:, 1]))
        uniforms.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32))(ks[:, 2]))
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


def _as_np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _compare_segment(jstates, jseg, tstates, tseg):
    np.testing.assert_array_equal(_np(tseg.accepted),
                                  np.asarray(jseg.accepted))
    np.testing.assert_allclose(_np(tseg.dH), np.asarray(jseg.dH), atol=1e-8)
    for name in ("delta_re", "delta_im", "pi_re", "pi_im"):
        np.testing.assert_allclose(_np(getattr(tstates, name)),
                                   np.asarray(getattr(jstates, name)),
                                   atol=1e-8, err_msg=name)
    np.testing.assert_allclose(_np(tstates.evals), np.asarray(jstates.evals),
                               atol=1e-8)
    for name in jseg.observables._fields:
        np.testing.assert_allclose(
            _np(getattr(tseg.observables, name)),
            np.asarray(getattr(jseg.observables, name)),
            rtol=1e-8, atol=1e-10, err_msg=name)


def _compare_transport(jp, jstates, tp, tstates):
    want = jens.ensemble_transport_real_jit(JL, JSpec(**SPEC), jp, jstates)
    got = tens.ensemble_transport_real(TL, TSpec(**SPEC), tp, tstates)
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-8, atol=1e-11, err_msg=name)


def test_tracked_segments_and_transport_match_jax():
    jp = jmake_params(W=0.5, n_imp=0.25, beta=BETA, J=1.0, dtype=jnp.float64)
    js = jens.init_ensemble_real(JL, jp, jax.random.PRNGKey(2), 2,
                                 dtype=jnp.float64, n_imp=0.25)
    tp = params_from_numpy(_as_np(jp), device="cpu")
    ts = state_from_numpy(_as_np(js), device="cpu")
    dt = calc_optimal_dt(BETA, 1.0, 1.0, NT)

    for n_sweeps, K in ((2, 1), (3, 2)):
        normals, uniforms = jax_segment_draws(js.key, n_sweeps)
        js, jseg = jens.run_segment_tracked(JL, jp, js, n_sweeps, NT, dt,
                                            anchor_every=K, **TRACK)
        ts, tseg = tens.run_segment_tracked(TL, tp, ts, n_sweeps, NT, dt,
                                            anchor_every=K, normals=normals,
                                            uniforms=uniforms, **TRACK)
        assert tseg.accepted.shape == (n_sweeps, 2)
        _compare_segment(js, jseg, ts, tseg)
        _compare_transport(jp, js, tp, ts)
    # the decisions exercised both outcomes, so the select logic was tested
    assert bool(tseg.accepted.any())


@pytest.mark.parametrize("K,init_chunk", [(1, None), (3, 1)])
def test_port_segment_runs_from_its_own_generator(K, init_chunk):
    """A port-only run (draws from one torch.Generator, per-chain β and dt)
    gives finite records of the right shape, and the same seed repeats."""
    betas = [4.0, 12.0, 30.0]
    p = make_params(W=0.5, n_imp=0.25, beta=betas, J=1.0,
                    dtype=torch.float64, device="cpu")
    dt = torch.tensor([calc_optimal_dt(b, 1.0, 1.0, 3) for b in betas],
                      dtype=torch.float64)

    def run():
        g = torch.Generator().manual_seed(0)
        s = tens.init_ensemble_real(TL, p, g, 3, dtype=torch.float64,
                                    n_imp=0.25, init_chunk=init_chunk,
                                    device="cpu")
        return tens.run_segment_tracked(TL, p, s, 4, 3, dt, anchor_every=K,
                                        generator=g, **TRACK)

    (s1, seg1), (s2, seg2) = run(), run()
    assert seg1.dH.shape == (4, 3)
    assert bool(torch.isfinite(seg1.dH).all())
    assert torch.equal(seg1.dH, seg2.dH) and torch.equal(s1.X, s2.X)
    assert seg1.observables.total_energy.shape == (4, 3)
