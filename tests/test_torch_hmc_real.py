"""Port parity: one tracked trajectory and both accept steps, with the JAX
package's momentum and accept draws replayed (``hmc_real.py`` splits each
chain's key into (key, k_mom, k_acc)), float64."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel.ensemble import init_ensemble_real as jinit_ens
from dwavehmc_tpu.sampler import hmc_real as jhmc
from dwavehmc_tpu.sampler.hmc import calc_optimal_dt
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.sampler import hmc_real as thmc
from dwavehmc_tpu_torch.sampler.hmc import draw_momenta
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
N = L * L
NT = 4
BETA = 10.0
TRACK = dict(tracked_iters=6, ns_steps=1, rot_scheme="exp2")


def _np(x):
    return x.detach().cpu().numpy()


def jax_draws(keys):
    """The draws of one sweep per chain: (next keys, normals, uniforms)."""
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    normals = jax.vmap(lambda k: jax.random.normal(
        k, (2, N, 2), jnp.float64))(ks[:, 1])
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(ks[:, 2])
    return ks[:, 0], np.array(normals), np.array(u)


@pytest.fixture(scope="module")
def ensemble():
    jp = jmake_params(W=0.5, n_imp=0.25, beta=BETA, J=1.0, dtype=jnp.float64)
    js = jinit_ens(JL, jp, jax.random.PRNGKey(11), 2, dtype=jnp.float64,
                   n_imp=0.25)
    as_np = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}  # noqa: E731
    return (jp, js, params_from_numpy(as_np(jp), device="cpu"),
            state_from_numpy(as_np(js), device="cpu"))


def _leapfrogs(ensemble, refine, polish):
    jp, js, tp, ts = ensemble
    dt = calc_optimal_dt(BETA, 1.0, 1.0, NT)
    fn = functools.partial(jhmc.tracked_leapfrog, JL, jp, Nt=NT, dt=dt,
                           refine_iters=refine, polish_iters=polish,
                           tracked_iters=6, ns_steps=1, rot_scheme="exp2")
    jprop = jax.vmap(lambda s: fn(state=s))(js)
    _, normals, u = jax_draws(js.key)
    tprop = thmc.tracked_leapfrog(TL, tp, ts, NT, dt, refine_iters=refine,
                                  polish_iters=polish, normals=normals,
                                  uniforms=u, **TRACK)
    return jprop, tprop


@pytest.mark.parametrize("refine,polish", [(0, 0), (6, 3)])
def test_tracked_leapfrog_matches(ensemble, refine, polish):
    jprop, tprop = _leapfrogs(ensemble, refine, polish)
    pairs = [(tprop.delta_re, jprop[0]), (tprop.delta_im, jprop[1]),
             (tprop.pi_re, jprop[2]), (tprop.pi_im, jprop[3]),
             (tprop.pi_re0, jprop[4]), (tprop.pi_im0, jprop[5]),
             (tprop.evals, jprop[9])]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-9)
    np.testing.assert_allclose(_np(tprop.res_max), np.asarray(jprop[8]),
                               atol=1e-9)
    np.testing.assert_allclose(_np(tprop.res_end), np.asarray(jprop[12]),
                               atol=1e-9)


@pytest.mark.parametrize("cheap", [False, True])
def test_accept_matches(ensemble, cheap):
    jp, js, tp, ts = ensemble
    jprop, tprop = _leapfrogs(ensemble, 6 if cheap else 0, 3 if cheap else 0)
    if cheap:
        jfn = lambda s, p: jhmc.tracked_accept_cheap(JL, jp, s, p)  # noqa: E731
        tnew, tinfo = thmc.tracked_accept_cheap(TL, tp, ts, tprop)
    else:
        jfn = lambda s, p: jhmc.tracked_accept(JL, jp, s, p)  # noqa: E731
        tnew, tinfo = thmc.tracked_accept(TL, tp, ts, tprop)
    jnew, jinfo = jax.vmap(jfn)(js, jprop)
    np.testing.assert_array_equal(_np(tinfo.accepted),
                                  np.asarray(jinfo.accepted))
    for name in ("dH", "H_old", "H_new"):
        np.testing.assert_allclose(_np(getattr(tinfo, name)),
                                   np.asarray(getattr(jinfo, name)),
                                   atol=1e-8, err_msg=name)
    for name in ("delta_re", "delta_im", "pi_re", "pi_im", "evals"):
        np.testing.assert_allclose(_np(getattr(tnew, name)),
                                   np.asarray(getattr(jnew, name)),
                                   atol=1e-8, err_msg=name)


def test_nonfinite_proposal_is_rejected_and_zeroed(ensemble):
    _, _, tp, ts = ensemble
    _, tprop = _leapfrogs(ensemble, 0, 0)
    bad = tprop.delta_re.clone()
    bad[0, 0, 0] = float("nan")
    new, info = thmc.tracked_accept(TL, tp, ts, tprop._replace(delta_re=bad))
    assert not bool(info.accepted[0])
    assert torch.equal(new.delta_re[0], ts.delta_re[0])
    assert bool(torch.isfinite(new.X).all())


def test_leapfrog_draws_from_generator(ensemble):
    _, _, tp, ts = ensemble
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = thmc.tracked_leapfrog(TL, tp, ts, 2, 0.05, generator=g1, **TRACK)
    normals, u = draw_momenta(g2, (2, 2, N, 2), torch.float64, "cpu")
    b = thmc.tracked_leapfrog(TL, tp, ts, 2, 0.05, normals=normals,
                              uniforms=u, **TRACK)
    assert torch.equal(a.delta_re, b.delta_re) and torch.equal(a.u, b.u)
    with pytest.raises(ValueError):
        thmc.tracked_leapfrog(TL, tp, ts, 2, 0.05, **TRACK)


def test_ph_solver_is_not_ported_yet(ensemble):
    """The anchor's solver switch: "ph" reaches the PH-split solver (its
    parity is in test_torch_ph_eigh.py) and an unknown name raises."""
    _, _, tp, ts = ensemble
    M = thmc.proposal_embedding(TL, tp, ts, thmc.Proposal(
        ts.delta_re, ts.delta_im, *([None] * 10)))
    w_ph, _, _ = thmc._exact_diagonalize(M, "ph")
    w_qd, _, _ = thmc._exact_diagonalize(M, "qdwh")
    np.testing.assert_allclose(_np(w_ph), _np(w_qd), atol=1e-10)
    with pytest.raises(ValueError):
        thmc._exact_diagonalize(M, "magma")
