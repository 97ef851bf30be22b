"""Port parity: the heavy transport and spectra measurement against the JAX
package's XLA path (``use_pallas=False``), float64, per-chain β."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import transport as jtr
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import SpectralSpec as JSpec
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.models.transport_real import (
    measure_transport_and_spectra_real as jmeasure,
)
from dwavehmc_tpu.parallel.ensemble import init_ensemble_real as jinit_ens
from dwavehmc_tpu_torch.models import transport as ttr
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import SpectralSpec as TSpec
from dwavehmc_tpu_torch.parallel.ensemble import ensemble_transport_real
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=0.5, n_imp=0.25, J=0.8, mass=1.0)
BETAS = np.array([3.0, 30.0])
SPEC = dict(eta=0.15, domega=0.1, omega_max=1.2)


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def ensemble():
    jp = jmake_params(beta=BETAS, dtype=jnp.float64, **PHYS)
    js = jinit_ens(JL, jmake_params(dtype=jnp.float64, **PHYS),
                   jax.random.PRNGKey(4), len(BETAS), dtype=jnp.float64,
                   n_imp=0.25)
    as_np = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}  # noqa: E731
    return (jp, js, params_from_numpy(as_np(jp), device="cpu"),
            state_from_numpy(as_np(js), device="cpu"))


def test_transport_and_spectra_match(ensemble):
    jp, js, tp, ts = ensemble
    axes = jp._replace(**{k: 0 if k == "beta" else None for k in jp._fields})
    want = jax.vmap(lambda p, s: jmeasure(JL, JSpec(**SPEC), p, s,
                                          use_pallas=False),
                    in_axes=(axes, 0))(jp, js)
    got = ensemble_transport_real(TL, TSpec(**SPEC), tp, ts)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = _np(getattr(got, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_conductivity_pieces_match(ensemble):
    """dc/optical through the K2 plain version equal the JAX XLA forms on
    the same |J|², including the degenerate-limit paramagnetic term."""
    rng = np.random.default_rng(0)
    evals = np.sort(rng.normal(size=(2, 12)), axis=-1)
    evals[:, 5] = evals[:, 4] + 1e-10             # a degenerate pair
    J2 = rng.uniform(size=(2, 12, 12))
    beta = np.array([2.0, 7.0])
    f = 1.0 / (1.0 + np.exp(beta[:, None] * evals))
    omega = np.linspace(0.1, 3.0, 30)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    for b in range(2):
        args = (jnp.asarray(evals[b]), jnp.asarray(f[b]), jnp.asarray(J2[b]))
        np.testing.assert_allclose(
            _np(ttr.paramagnetic_term(t(evals), t(f), t(J2), t(beta), 6))[b],
            float(jtr.paramagnetic_term(*args, beta[b], 6)), rtol=1e-12)
        np.testing.assert_allclose(
            _np(ttr.dc_conductivity(t(evals), t(f), t(J2), t(beta), 0.2, 6))[b],
            float(jtr.dc_conductivity(*args, beta[b], 0.2, 6)), rtol=1e-12)
        np.testing.assert_allclose(
            _np(ttr.optical_conductivity(t(omega), t(evals), t(f), t(J2),
                                         0.2, 6))[b],
            np.asarray(jtr.optical_conductivity(jnp.asarray(omega), *args,
                                                0.2, 6)), rtol=1e-12)
