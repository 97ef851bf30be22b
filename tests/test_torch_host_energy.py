"""Port parity for the host float64 Metropolis readout: ``ops/host_energy``
(numpy, to 1e-12 relative) and ``parallel/ensemble.run_segment_hostacc``
against the JAX package's, float64 on the CPU, L=4, the JAX draws replayed.

The recorded ΔH is float32 in both packages (it is what decides); the
float64 potentials behind it, kept in the readout's cache, agree to 1e-9
relative.  Also: the cache fingerprint across clean-lattice subsets, the
rejection of a non-finite proposal, and ``RunConfig.validate``'s rule for
the host readout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.drivers.scan import _broadcast_params as jbroadcast
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.ops import host_energy as jhe
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.sampler.hmc import calc_optimal_dt
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.ops import host_energy as the
from dwavehmc_tpu_torch.parallel import ensemble as tens
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy
from dwavehmc_tpu_torch.utils.config import RunConfig

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
N = L * L
NT = 4
BETAS = np.array([20.0, 400.0])
TRACK = dict(tracked_iters=6, ns_steps=1, rot_scheme="exp2")


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
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms)), keys


def _random_chain(seed):
    rng = np.random.default_rng(seed)
    dis = (rng.random(N) < 0.3).astype(np.float64)
    return dis, 0.05 * rng.normal(size=(N, 2)), 0.05 * rng.normal(size=(N, 2))


def test_numpy_functions_match_jax():
    dis, dre, dim = _random_chain(0)
    H_t = the.complex_bdg_np(TL, 1.0, -0.35, -1.08, dis, dre, dim)
    np.testing.assert_array_equal(
        H_t, jhe.complex_bdg_np(JL, 1.0, -0.35, -1.08, dis, dre, dim))
    ev = np.linalg.eigvalsh(H_t)
    assert the.fermion_energy_np(ev, 7.0) == pytest.approx(
        jhe.fermion_energy_np(ev, 7.0), rel=1e-12)
    args = (1.0, -0.35, -1.08, 7.0, 0.8, dis, dre, dim)
    assert the.potential_energy_np(TL, *args) == pytest.approx(
        jhe.potential_energy_np(JL, *args), rel=1e-12)
    pr, pi = np.stack([dre, dim]) * 3.0, np.stack([dim, dre]) - 0.5
    np.testing.assert_allclose(the.kinetic_energy_np(pr, pi, 1.3),
                               jhe.kinetic_energy_np(pr, pi, 1.3), rtol=1e-12)

    # per-chain couplings: the port's (B,) torch tensors against JAX arrays
    chains = [_random_chain(s) for s in (1, 2)]
    dis_b, dre_b, dim_b = (np.stack(x) for x in zip(*chains))
    jp = jbroadcast(jmake_params(W=1.0, J=0.8, mass=1.5, dtype=jnp.float64),
                    2, beta=BETAS)
    tp = params_from_numpy(_as_np(jp), device="cpu")
    np.testing.assert_allclose(
        the.potential_batch_np(TL, tp, dis_b, dre_b, dim_b),
        jhe.potential_batch_np(JL, jp, dis_b, dre_b, dim_b, params_axis=0),
        rtol=1e-12)
    np.testing.assert_array_equal(the.mass_array_np(tp, 2),
                                  jhe.mass_array_np(jp, 2, params_axis=0))
    with pytest.raises(ValueError):          # params and states subset apart
        the.potential_batch_np(TL, tp, dis_b[:1].repeat(3, 0),
                               dre_b[:1].repeat(3, 0),
                               dim_b[:1].repeat(3, 0))


@pytest.fixture(scope="module")
def ensemble():
    """JAX and port ensembles of two disordered chains at per-chain β, with
    the couplings broadcast per chain as the scan hands them in."""
    base = jmake_params(W=0.5, n_imp=0.25, J=0.8, dtype=jnp.float64)
    jp = jbroadcast(base, 2, beta=BETAS)
    js = jens.init_ensemble_real(JL, base, jax.random.PRNGKey(3), 2,
                                 dtype=jnp.float64, n_imp=0.25,
                                 exact_solver="ph")
    return (jp, js, params_from_numpy(_as_np(jp), device="cpu"),
            state_from_numpy(_as_np(js), device="cpu"))


def test_run_segment_hostacc_matches_jax(ensemble):
    """Two segments, the cache carried from the first into the second, the
    guarded PH anchor every sweep: equal accept decisions, equal float32
    ΔH, float64 potentials to 1e-9 relative."""
    jp, js, tp, ts = ensemble
    dt = 0.5 * np.asarray([calc_optimal_dt(b, 0.8, 1.0, NT) for b in BETAS])
    kw = dict(measure=True, exact_solver="ph", **TRACK)
    j1, jseg1, jc = jens.run_segment_hostacc(
        JL, jp, js, 2, NT, jnp.asarray(dt), params_axis=0, dt_axis=0,
        rot_dtype=None, **kw)
    j2, jseg2, jc = jens.run_segment_hostacc(
        JL, jp, j1, 1, NT, jnp.asarray(dt), params_axis=0, dt_axis=0,
        rot_dtype=None, pot_cache=jc, **kw)
    n1, u1, keys = jax_draws(js.key, 2)
    n2, u2, _ = jax_draws(keys, 1)
    t1, tseg1, tc = tens.run_segment_hostacc(
        TL, tp, ts, 2, NT, torch.as_tensor(dt), normals=n1, uniforms=u1,
        **kw)
    t2, tseg2, tc = tens.run_segment_hostacc(
        TL, tp, t1, 1, NT, torch.as_tensor(dt), normals=n2, uniforms=u2,
        pot_cache=tc, **kw)
    for tseg, jseg in ((tseg1, jseg1), (tseg2, jseg2)):
        np.testing.assert_array_equal(_np(tseg.accepted),
                                      np.asarray(jseg.accepted))
        assert tseg.dH.dtype == torch.float32
        np.testing.assert_allclose(_np(tseg.dH), np.asarray(jseg.dH),
                                   rtol=1e-6, atol=1e-6)
        for name in jseg.observables._fields:
            np.testing.assert_allclose(
                _np(getattr(tseg.observables, name)),
                np.asarray(getattr(jseg.observables, name)), rtol=1e-9,
                atol=1e-10, err_msg=name)
    assert bool(tseg1.accepted.any())
    np.testing.assert_allclose(tc["pot"], jc["pot"], rtol=1e-9)
    # the returned fingerprint covers the final state (bit-level: the two
    # packages' states agree to 1e-10, not in every byte)
    assert tc["fp"] == tens._hostacc_fingerprint(
        tp, _np(t2.disorder), _np(t2.delta_re), _np(t2.delta_im))
    np.testing.assert_allclose(_np(t2.delta_re), np.asarray(j2.delta_re),
                               atol=1e-10)


def test_cache_fingerprint_across_clean_subsets():
    """On a clean lattice every equal-sized subset of chains has the same
    all-zeros disorder: a subset at another β handed the first subset's
    cache must recompute, as a fresh run does; a Δ change misses too; a
    cache whose fingerprint matches is trusted."""
    def clean(beta, seed):
        jp = jmake_params(W=1.0, n_imp=0.0, beta=beta, J=0.8,
                          dtype=jnp.float64)
        js = jens.init_ensemble_real(JL, jp, jax.random.PRNGKey(seed), 2,
                                     dtype=jnp.float64, exact_solver="qdwh")
        return (params_from_numpy(_as_np(jp), device="cpu"),
                state_from_numpy(_as_np(js), device="cpu"), jp, js)

    pa, sa, jpa, jsa = clean(50.0, 0)
    pb, sb, _, _ = clean(2000.0, 1)
    assert not bool(sa.disorder.any()) and not bool(sb.disorder.any())

    def run(p, s, beta, cache, seed=5):
        return tens.run_segment_hostacc(
            TL, p, s, 1, NT, calc_optimal_dt(beta, 0.8, 1.0, NT),
            measure=False, pot_cache=cache, **TRACK,
            generator=torch.Generator().manual_seed(seed))

    _, _, cache_a = run(pa, sa, 50.0, None)
    _, res_poison, _ = run(pb, sb, 2000.0, dict(cache_a))
    _, res_fresh, _ = run(pb, sb, 2000.0, None)
    assert torch.equal(res_poison.dH, res_fresh.dH)

    fp = tens._hostacc_fingerprint
    dre, dim = _np(sa.delta_re), _np(sa.delta_im)
    dis = _np(sa.disorder)
    assert fp(pa, dis, dre, dim) != fp(pa, dis, dre + 1e-3, dim)
    assert fp(pa, dis, dre, dim) != fp(pb, dis, dre, dim)
    # the same bytes and couplings give the JAX package's fingerprint
    assert fp(pa, dis, dre, dim) == jens._hostacc_fingerprint(
        jpa, np.asarray(jsa.disorder), np.asarray(jsa.delta_re),
        np.asarray(jsa.delta_im), None)
    pot0 = the.potential_batch_np(TL, pa, dis, dre, dim)
    _, res_trusted, _ = run(pa, sa, 50.0,
                            {"fp": fp(pa, dis, dre, dim), "pot": pot0 + 1.0})
    _, res_own, _ = run(pa, sa, 50.0, None)
    np.testing.assert_allclose(_np(res_trusted.dH), _np(res_own.dH) - 1.0,
                               rtol=1e-5)


def test_nonfinite_proposal_is_rejected(ensemble):
    """A NaN Δ has potential +inf, so ΔH is not finite and the chain keeps
    its state and its cached potential; the other chain goes on."""
    _, _, tp, ts = ensemble
    dis, dre, dim = _random_chain(6)
    dre[0, 0] = np.nan
    assert the.potential_energy_np(TL, 1.0, -0.35, -1.08, 10.0, 0.8, dis,
                                   dre, dim) == float("inf")
    dt = torch.as_tensor([float("nan"),
                          calc_optimal_dt(BETAS[1], 0.8, 1.0, NT)])
    args = (tp, _np(ts.disorder), _np(ts.delta_re), _np(ts.delta_im))
    cache0 = {"fp": tens._hostacc_fingerprint(*args),
              "pot": the.potential_batch_np(TL, *args)}
    new, seg, cache = tens.run_segment_hostacc(
        TL, tp, ts, 1, NT, dt, measure=False, pot_cache=dict(cache0),
        generator=torch.Generator().manual_seed(1), **TRACK)
    assert not bool(seg.accepted[0, 0])
    assert not bool(torch.isfinite(seg.dH[0, 0]))
    assert torch.equal(new.delta_re[0], ts.delta_re[0])
    assert bool(torch.isfinite(new.X).all())
    assert cache["pot"][0] == cache0["pot"][0]


def test_validate_applies_the_host_readout_rule():
    with pytest.raises(ValueError):
        RunConfig(metropolis_readout="host").validate()      # exact mode
    with pytest.raises(ValueError):
        RunConfig(metropolis_readout="host", eigh_mode="tracked",
                  path="complex").validate()
    RunConfig(metropolis_readout="host", eigh_mode="tracked").validate()
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "examples", "T_scan_cold_host_24x24",
                           "scan_config.json")) as f:
        saved = json.load(f)
    for k in ("scan_param", "values", "replicas"):
        saved.pop(k)
    cfg = RunConfig(**saved)
    cfg.validate()
    assert cfg.resolved_path() == "real"
