"""Port parity: the complex path's heavy measurement
(``measure_transport_and_spectra``) and the f-sum check against the JAX
package's XLA path (``use_pallas=False``), per-chain β, L=4 — in float64
to 1e-10, and in float32 (complex64 eigenvectors) at K2's rtol of 2e-4,
each field's error taken relative to its largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import transport as jtr
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import SpectralSpec as JSpec
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel.ensemble import init_ensemble as jinit_ens
from dwavehmc_tpu_torch.models import transport as ttr
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import SpectralSpec as TSpec
from dwavehmc_tpu_torch.ops.spectral import fermi_factors
from dwavehmc_tpu_torch.parallel.ensemble import ensemble_transport
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy

torch.set_num_threads(2)

L = 4
JL, TL = JLat(L, L), TLat(L, L)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=0.5, n_imp=0.25, J=0.8, mass=1.0)
BETAS = np.array([3.0, 30.0])
SPEC = dict(eta=0.15, domega=0.1, omega_max=1.2)


def _np(x):
    return x.detach().cpu().numpy()


def _as_np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def ensemble():
    jp = jmake_params(beta=BETAS, dtype=jnp.float64, **PHYS)
    js = jinit_ens(JL, jmake_params(dtype=jnp.float64, **PHYS),
                   jax.random.PRNGKey(4), len(BETAS), dtype=jnp.float64,
                   n_imp=0.25)
    return jp, js


def _jax_measure(jp, js):
    axes = jp._replace(**{k: 0 if k == "beta" else None for k in jp._fields})
    return jax.vmap(lambda p, s: jtr.measure_transport_and_spectra(
        JL, JSpec(**SPEC), p, s, use_pallas=False), in_axes=(axes, 0))(jp, js)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_transport_and_spectra_match(ensemble, dtype):
    jp, js = ensemble
    if dtype == "float32":
        f32 = lambda x: x.astype(jnp.complex64 if jnp.iscomplexobj(x)  # noqa: E731
                                 else jnp.float32)
        jp = jax.tree.map(f32, jp)
        js = jax.tree.map(lambda x: x if x.dtype == jnp.uint32 else f32(x),
                          js)
    want = _jax_measure(jp, js)
    got = ensemble_transport(TL, TSpec(**SPEC),
                             params_from_numpy(_as_np(jp), device="cpu"),
                             state_from_numpy(_as_np(js), device="cpu"))
    rtol = 1e-10 if dtype == "float64" else 2e-4
    for name in want._fields:
        w = np.asarray(getattr(want, name), np.float64)
        g = _np(getattr(got, name)).astype(np.float64)
        assert g.shape == w.shape, name
        assert str(getattr(got, name).dtype).endswith(dtype), name
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


def test_f_sum_check_matches_jax(ensemble):
    jp, js = ensemble
    spec = JSpec(**SPEC)
    res = _jax_measure(jp, js)
    omega = spec.omega_grid()
    tp = params_from_numpy(_as_np(jp), device="cpu")
    ts = state_from_numpy(_as_np(js), device="cpu")
    f = fermi_factors(ts.evals, tp.beta)
    J2 = torch.abs(ttr.current_matrix_elements(TL, ts.evecs, tp.t,
                                               tp.tp)) ** 2
    got = ttr.f_sum_check(torch.as_tensor(omega),
                          torch.as_tensor(np.array(res.optical_conductivity)),
                          ts.evals, f, J2, TL.n_sites)
    for b in range(len(BETAS)):
        fb = jax.nn.sigmoid(-BETAS[b] * js.evals[b])
        J2b = jnp.abs(jtr.current_matrix_elements(JL, js.evecs[b], 1.0,
                                                  -0.35)) ** 2
        want = jtr.f_sum_check(jnp.asarray(omega),
                               res.optical_conductivity[b], js.evals[b], fb,
                               J2b, JL.n_sites)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g[b]), float(w), rtol=1e-10)
