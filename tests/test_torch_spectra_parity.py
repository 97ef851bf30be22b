"""``drivers/spectra_parity_production``'s two legs against the JAX
package's, on the CPU at 6×6 with a seeded random (non-degenerate) Δ and
disorder at the script's β:

* the production leg (float32 real path): its eigenvalues within 1e-5 of
  ‖E‖∞ of the JAX real path's, and its measurement on the JAX eigenpairs
  within 1e-5 of the JAX real path (``use_pallas=False``, its plain
  reference), relative to each observable's peak.  (The two float32
  eigensolvers alone move ρ_s by about 2e-5 relative: at this seed the
  JAX leg is 2.2e-5 off the float64 oracle, the port's 1.0e-6);
* the oracle leg (complex128 eigh, float64 complex measurement) within
  1e-10 of the JAX complex path in float64, its f-sum record equal to
  JAX's ``f_sum_check`` on the same state;
* the per-chain record and the verdict: the production leg passes the
  script's tolerances against the oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bdg_real as jbdg_real
from dwavehmc_tpu.models.bdg import assemble_bdg as jassemble_bdg
from dwavehmc_tpu.models.bdg import static_hamiltonian as jstatic_ham
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import HMCState as JState
from dwavehmc_tpu.models.params import SpectralSpec as JSpec
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.models.transport import (
    current_matrix_elements as jcurrent,
)
from dwavehmc_tpu.models.transport import f_sum_check as jf_sum
from dwavehmc_tpu.models.transport import (
    measure_transport_and_spectra as jmeasure,
)
from dwavehmc_tpu.models.transport_real import (
    measure_transport_and_spectra_real as jmeasure_real,
)
from dwavehmc_tpu.ops.spectral import fermi_factors as jfermi
from dwavehmc_tpu.sampler.hmc_real import HMCStateReal as JStateReal
from dwavehmc_tpu_torch.drivers import spectra_parity_production as spp
from dwavehmc_tpu_torch.models.lattice import LatticeSpec

torch.set_num_threads(2)

L = 6
BETA = 1.0 / spp.T_POINT
FIELDS = ("superfluid_stiffness", "dc_conductivity", "optical_conductivity",
          "dos", "dos_AN", "A_k0")


@pytest.fixture(scope="module")
def chain():
    """(Δ (N, 2) complex64, disorder (N,) float32) of a seeded random
    state: |Δ| ≈ 0.2 with random phases, impurities of strength W at 5 %
    of the sites."""
    rng = np.random.default_rng(7)
    N = L * L
    delta = (0.2 * rng.uniform(0.5, 1.5, (N, 2))
             * np.exp(2j * np.pi * rng.uniform(size=(N, 2))))
    disorder = np.zeros(N)
    disorder[rng.permutation(N)[:round(0.05 * N)]] = 1.0
    return delta.astype(np.complex64), disorder.astype(np.float32)


def peak_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def jax_params(dtype):
    return jmake_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05,
                        beta=BETA, J=0.8, mass=1.0, dtype=dtype)


def test_production_leg_matches_the_jax_real_path(chain):
    delta, disorder = chain
    lat, jlat = LatticeSpec(L, L), JLat(L, L)
    spec = spp.production_spec(lat)
    params, state = spp.production_state(lat, delta, disorder, BETA, "cpu")

    dre = jnp.asarray(delta.real, jnp.float32)
    dim_ = jnp.asarray(delta.imag, jnp.float32)
    dis = jnp.asarray(disorder, jnp.float32)
    M = jbdg_real.assemble_embedding(
        jlat, jbdg_real.static_embedding(jlat, 1.0, -0.35, -1.08, dis),
        dre, dim_)
    jev, X, Y = jbdg_real.diagonalize_embedding(M)
    z = jnp.zeros_like(dre)
    st = JStateReal(dre, dim_, z, z, dis, jev, X, Y, jax.random.PRNGKey(0))
    want = jmeasure_real(jlat, JSpec(eta=spec.eta, domega=spec.domega,
                                     omega_max=spec.omega_max),
                         jax_params(jnp.float32), st, use_pallas=False)
    scale = np.abs(np.asarray(jev)).max()
    np.testing.assert_allclose(np.sort(state.evals[0].numpy()),
                               np.sort(np.asarray(jev)), rtol=0,
                               atol=1e-5 * scale)

    def as_port(a):
        return torch.as_tensor(np.array(a))[None]

    jstate = state._replace(evals=as_port(jev), X=as_port(X), Y=as_port(Y))
    _, got = spp.production_measurement(lat, spec, params, jstate)
    for k in FIELDS:
        assert peak_rel(got[k], getattr(want, k)) <= 1e-5, k


def test_oracle_leg_matches_the_jax_complex_path(chain):
    delta, disorder = chain
    lat, jlat = LatticeSpec(L, L), JLat(L, L)
    spec = spp.production_spec(lat)
    ev, got, f_sum = spp.oracle_leg(lat, spec, delta, disorder, BETA, "cpu")

    p64 = jax_params(jnp.float64)
    d64 = jnp.asarray(delta, jnp.complex128)
    dis = jnp.asarray(disorder, jnp.float64)
    H = jassemble_bdg(jlat, jstatic_ham(jlat, 1.0, -0.35, -1.08, dis), d64)
    jev, U = jnp.linalg.eigh(H)
    st = JState(delta=d64, pi=jnp.zeros_like(d64), disorder=dis, evals=jev,
                evecs=U, key=jax.random.PRNGKey(0))
    jspec = JSpec(eta=spec.eta, domega=spec.domega, omega_max=spec.omega_max)
    want = jmeasure(jlat, jspec, p64, st, use_pallas=False)
    np.testing.assert_allclose(ev, np.asarray(jev), rtol=0, atol=1e-12)
    for k in FIELDS:
        assert peak_rel(got[k], getattr(want, k)) <= 1e-10, k

    f = jfermi(jev, p64.beta)
    J2 = jnp.abs(jcurrent(jlat, U, 1.0, -0.35)) ** 2
    om = jnp.asarray(spec.omega_grid(), jnp.float64)
    _, _, rel = jf_sum(om, want.optical_conductivity, jev, f, J2, L * L)
    assert f_sum["production_grid_rel_err"] == round(float(rel), 4)


def test_chain_record_passes_the_scripts_tolerances(chain):
    delta, disorder = chain
    lat = LatticeSpec(L, L)
    row = spp.compare_chain(lat, spp.production_spec(lat), delta, disorder,
                            BETA, "cpu")
    assert set(row) == {"eigh_evals", *FIELDS, "f_sum"}
    for k in FIELDS:
        assert row[k]["rel_to_peak"] <= spp.TOL_REL, k
    assert spp.verdict([row])
    bad = dict(row, dos=dict(row["dos"], rel_to_peak=2 * spp.TOL_REL))
    assert not spp.verdict([row, bad])
