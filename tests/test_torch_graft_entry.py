"""The port's graft entry (``dwavehmc_tpu_torch/graft_entry.py``) against
the JAX package's root ``__graft_entry__.py`` on the CPU.

* ``entry``'s sweep on the JAX entry's initial state and draws: Δ within
  1e-5 and dH within 1e-3 in float32, and the same wrapped sweep in float64
  within 1e-10;
* ``dryrun_multichip(2)`` under two gloo ranks, with its own launch limit
  that kills the ranks' process groups.
"""

import numpy as np
import pytest
import torch

from dwavehmc_tpu_torch import graft_entry
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.sampler.hmc_real import init_chain_state_real

torch.set_num_threads(2)

def _jax_sweep(dtype):
    """The JAX entry's (fn, (params, state)) in ``dtype``, and its sweep's
    standard normals (2, N, 2) and accept uniform, split from the state's
    key as ``hmc_sweep_real`` splits it."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from dwavehmc_tpu import LatticeSpec as JLat
    from dwavehmc_tpu import make_params as jmake_params
    from dwavehmc_tpu.sampler.hmc_real import (
        hmc_sweep_real, init_chain_state_real as jinit)

    fn, (params, state) = __graft_entry__.entry()
    if dtype == jnp.float64:
        lat = JLat(8, 8)
        params = jmake_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05,
                              beta=10.0, J=0.8, mass=1.0, dtype=dtype)
        state = jinit(lat, params, jax.random.PRNGKey(0), dtype=dtype,
                      n_imp=0.05)

        def fn(params, state):
            new_state, info = hmc_sweep_real(lat, params, state, 4, 0.05)
            return new_state.delta_re, info.dH

    _, k_mom, k_acc = jax.random.split(state.key, 3)
    normals = jax.random.normal(k_mom, (2,) + state.delta_re.shape, dtype)
    uniform = jax.random.uniform(k_acc, (), dtype=jnp.float32)
    return fn, params, state, np.array(normals), np.array(uniform)


@pytest.mark.parametrize("dtype,tol_delta,tol_dH", [
    ("float32", 1e-5, 1e-3), ("float64", 1e-10, 1e-10)])
def test_entry_sweep_matches_the_jax_entry(dtype, tol_delta, tol_dH):
    import jax.numpy as jnp

    jfn, jparams, jstate, normals, uniform = _jax_sweep(getattr(jnp, dtype))
    want_delta, want_dH = (np.asarray(x) for x in jfn(jparams, jstate))

    tdt = getattr(torch, dtype)
    fn, (params, state) = graft_entry.entry(device="cpu")
    assert state.delta_re.dtype == torch.float32
    assert state.delta_re.shape == (1, 64, 2)
    if tdt == torch.float64:   # the entry's params in float64, for its fn
        params = make_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05,
                             beta=10.0, J=0.8, mass=1.0, dtype=tdt,
                             device="cpu")
    # the JAX entry's initial state, in the case's dtype
    state = init_chain_state_real(
        LatticeSpec(8, 8), params, 1, dtype=tdt, device="cpu",
        disorder=np.array(jstate.disorder)[None],
        delta0_re=np.array(jstate.delta_re)[None],
        delta0_im=np.array(jstate.delta_im)[None])
    delta, dH = fn(params, state, normals=torch.as_tensor(normals)[None],
                   uniforms=torch.as_tensor(uniform)[None])
    assert delta.shape == (1, 64, 2) and dH.shape == (1,)
    np.testing.assert_allclose(delta[0].numpy(), want_delta, atol=tol_delta)
    np.testing.assert_allclose(float(dH[0]), float(want_dH), atol=tol_dH)

    # and on the draws of its own generator
    delta2, dH2 = fn(params, state)
    assert torch.isfinite(delta2).all() and torch.isfinite(dH2).all()


def test_dryrun_multichip_over_two_gloo_ranks():
    # the ranks run under the launcher's own limit, which kills their
    # process groups: a deadlock fails the test instead of hanging it
    assert graft_entry.DRYRUN_SECONDS <= 240
    reports = graft_entry.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in reports] == [0, 1]
    assert [r["rows"] for r in reports] == [[0, 1], [1, 2]]
    assert [r["rows_2d"] for r in reports] == [[0, 2], [2, 4]]
    assert all(r["layout_2d"] == [2, 1] for r in reports)
    # W = 1.0 at n_imp = 0.25, as in the JAX dry run: 4 of 16 sites a chain
    assert [r["impurities"] for r in reports] == [[4], [4]]
    assert [r["impurities_2d"] for r in reports] == [[4, 4], [4, 4]]
    assert len({r["collectives"] for r in reports}) == 1
    for r in reports:
        assert set(r["steps"]) == {"real", "tracked", "ph_exp2", "hostacc",
                                   "rho_s", "complex", "grid_chain"}
        assert np.all(np.isfinite(np.asarray(r["steps"]["grid_chain"])))
