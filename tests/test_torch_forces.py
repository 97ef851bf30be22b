"""Port parity: real-pair forces and light observables from the same
eigenpairs as the JAX package, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.observables_real import measure_observables_real as jobs
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.ops.forces_real import hmc_forces_real as jforces
from dwavehmc_tpu.parallel.ensemble import init_ensemble_real as jinit_ens
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.observables_real import measure_observables_real
from dwavehmc_tpu_torch.ops.forces_real import hmc_forces_real
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=0.5, n_imp=0.25, J=0.8, mass=1.0)
BETAS = np.array([2.0, 25.0])


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def ensemble():
    jp = jmake_params(beta=BETAS, dtype=jnp.float64, **PHYS)
    js = jinit_ens(JL, jmake_params(dtype=jnp.float64, **PHYS),
                   jax.random.PRNGKey(7), len(BETAS), dtype=jnp.float64,
                   n_imp=0.25)
    as_np = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}  # noqa: E731
    tp = params_from_numpy(as_np(jp), device="cpu")
    ts = state_from_numpy(as_np(js), device="cpu")
    return jp, js, tp, ts


def test_carry_keeps_values_and_dtype(ensemble):
    jp, js, tp, ts = ensemble
    assert ts.X.dtype == torch.float64 and tp.beta.shape == (len(BETAS),)
    np.testing.assert_array_equal(_np(ts.X), np.asarray(js.X))
    np.testing.assert_array_equal(_np(tp.beta), BETAS)
    assert tp.J.ndim == 0


def test_forces_match(ensemble):
    jp, js, tp, ts = ensemble
    want = jax.vmap(lambda b, s: jforces(JL, s.delta_re, s.delta_im, s.evals,
                                         s.X, s.Y, b, jp.J))(jp.beta, js)
    got = hmc_forces_real(TL, ts.delta_re, ts.delta_im, ts.evals, ts.X, ts.Y,
                          tp.beta, tp.J)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-10)


def test_observables_match(ensemble):
    jp, js, tp, ts = ensemble
    want = jax.vmap(lambda p, s: jobs(JL, p, s),
                    in_axes=(jp._replace(**{k: 0 if k == "beta" else None
                                            for k in jp._fields}), 0))(jp, js)
    got = measure_observables_real(TL, tp, ts)
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
