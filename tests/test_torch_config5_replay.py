"""Config 5's 32×32 replay draws, ``tests/data/config5_replay_32x32.npz``.

The card has no JAX, so the JAX run's draws travel as a file.  It holds,
for two 32×32 chains at config 5's couplings (``drivers/demo_config5.PHYS``,
β = 20) and for each of float32 (``f32_*``) and float64 (``f64_*``), the
inputs of
``tests/test_torch_config5.py::test_first_therm_sweep_matches_the_jax_package``'s
32×32 cases: the JAX run's disorder, Δ0 (re, im), first-sweep momenta
normals (1, 2, 2, N, 2) and accept uniforms (1, 2), and the sweep's dt.
Beside them, the dH and decisions of that sweep on the CPU, as recorded
from those cases (they take half an hour on the CPU, so they are not
rerun here): each package's dH in each dtype, and the port's float64 dH on
the float32 inputs cast up.  ``chip_smoke.py``'s ``config5.replay`` runs
the port on the card on these draws
(``drivers/demo_config5.replay_first_therm_sweep``) and holds it to them.

The draws need no eigensolver (``init_chain_state_real(diagonalize=False)``
draws what ``init_ensemble_real`` draws), so the file is rebuilt and
compared in seconds.  Write it anew with

    python tests/test_torch_config5_replay.py
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dwavehmc_tpu_torch.drivers import demo_config5 as c5  # noqa: E402
from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt  # noqa: E402

DATA = os.path.join(REPO, "tests", "data", "config5_replay_32x32.npz")
L, CHAINS = 32, 2
DTYPES = {"f32": "float32", "f64": "float64"}
#: the first therm sweep's dH and decisions on the CPU, from the 32×32
#: cases of test_first_therm_sweep_matches_the_jax_package
RECORDED = {
    "f64_dH_port_cpu": [2.2068193737869706, 2.2088906435294575],
    "f64_dH_jax_cpu": [2.2068193737778756, 2.2088906435116087],
    "f32_dH_port_cpu": [2.185546875, 2.190673828125],
    "f32_dH_jax_cpu": [2.1756591796875, 2.18597412109375],
    "f32_dH_port_cpu_float64": [2.180694601446021, 2.18819811579624],
    "f64_accepted_cpu": [False, False],
    "f32_accepted_cpu": [False, False],
}


def jax_draws(L: int, chains: int) -> dict:
    """The JAX package's initial ensemble (``PRNGKey(0)``, n_imp = 0.05)
    and first-sweep draws at ``L``, in both dtypes, without the initial
    eigensolve."""
    import jax
    import jax.numpy as jnp

    from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
    from dwavehmc_tpu.models.params import make_params as jmake_params
    from dwavehmc_tpu.sampler.hmc_real import init_chain_state_real

    n = L * L
    out = {"dt": np.float64(calc_optimal_dt(20.0, 0.8, 1.0, c5.REPLAY_NT))}
    for tag, name in DTYPES.items():
        jdt = getattr(jnp, name)
        jp = jmake_params(**c5.PHYS, dtype=jdt)
        init = functools.partial(init_chain_state_real, JLat(L, L), jp,
                                 dtype=jdt, n_imp=0.05, diagonalize=False)
        js = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0), chains))
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(js.key)
        out[f"{tag}_disorder"] = np.array(js.disorder)
        out[f"{tag}_delta_re"] = np.array(js.delta_re)
        out[f"{tag}_delta_im"] = np.array(js.delta_im)
        out[f"{tag}_normals"] = np.array(jax.vmap(lambda k: jax.random.normal(
            k, (2, n, 2), jdt))(ks[:, 1]))[None]
        out[f"{tag}_uniforms"] = np.array(jax.vmap(
            lambda k: jax.random.uniform(k, (), jnp.float32))(ks[:, 2]))[None]
    return out


def write(path: str = DATA) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **jax_draws(L, CHAINS),
                        **{k: np.asarray(v) for k, v in RECORDED.items()})


def test_the_file_holds_the_jax_draws():
    """A rebuild from the JAX package gives the file's arrays bit for
    bit."""
    got = np.load(DATA)
    want = jax_draws(L, CHAINS)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype, k


def test_the_file_has_its_keys_shapes_dtypes_and_recorded_values():
    d = np.load(DATA)
    assert os.path.getsize(DATA) < 1_000_000
    n = L * L
    for tag, name in DTYPES.items():
        shapes = {"disorder": (CHAINS, n), "delta_re": (CHAINS, n, 2),
                  "delta_im": (CHAINS, n, 2),
                  "normals": (1, CHAINS, 2, n, 2)}
        for k, shape in shapes.items():
            assert d[f"{tag}_{k}"].shape == shape, (tag, k)
            assert d[f"{tag}_{k}"].dtype == np.dtype(name), (tag, k)
        assert d[f"{tag}_uniforms"].shape == (1, CHAINS)
        assert d[f"{tag}_uniforms"].dtype == np.float32
        assert np.isfinite(d[f"{tag}_normals"]).all()
    assert d["dt"].shape == () and float(d["dt"]) == calc_optimal_dt(
        20.0, 0.8, 1.0, 20)
    assert sorted(d.files) == sorted(
        [f"{t}_{k}" for t in DTYPES for k in ("disorder", "delta_re",
                                              "delta_im", "normals",
                                              "uniforms")]
        + ["dt"] + list(RECORDED))
    for k, v in RECORDED.items():
        np.testing.assert_array_equal(d[k], np.asarray(v), err_msg=k)
    # the recorded values agree as the ROADMAP says: float64 packages to
    # 2e-11, each float32 package within 5.1e-3 of float64 on its inputs
    np.testing.assert_allclose(d["f64_dH_port_cpu"], d["f64_dH_jax_cpu"],
                               rtol=0, atol=2e-11)
    for k in ("f32_dH_port_cpu", "f32_dH_jax_cpu"):
        assert np.abs(d[k] - d["f32_dH_port_cpu_float64"]).max() < 5.1e-3


@pytest.mark.parametrize("tag,atol", [("f64", 1e-8), ("f32", 1e-3)])
def test_replay_matches_the_jax_sweep_at_6x6(tag, atol):
    """``replay_first_therm_sweep`` on the draws ``jax_draws`` makes, at
    6×6, against the JAX package's first therm sweep from its own
    ``init_ensemble_real`` (whose draws must be ``jax_draws``'): dH
    within ``atol`` and the same decisions."""
    import jax
    import jax.numpy as jnp

    from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
    from dwavehmc_tpu.models.params import make_params as jmake_params
    from dwavehmc_tpu.parallel import ensemble as jens

    torch.set_num_threads(2)
    Ls = 6
    d = jax_draws(Ls, CHAINS)
    jdt = getattr(jnp, DTYPES[tag])
    jp = jmake_params(**c5.PHYS, dtype=jdt)
    js = jens.init_ensemble_real(JLat(Ls, Ls), jp, jax.random.PRNGKey(0),
                                 CHAINS, dtype=jdt, n_imp=0.05)
    np.testing.assert_array_equal(np.array(js.disorder), d[f"{tag}_disorder"])
    np.testing.assert_array_equal(np.array(js.delta_re), d[f"{tag}_delta_re"])
    _, jseg = jens.run_segment_tracked(
        JLat(Ls, Ls), jp, js, 1, c5.REPLAY_NT,
        jnp.full((CHAINS,), float(d["dt"]), jdt), False, None, 0,
        c5.REPLAY_ITERS)
    dH, accepted = c5.replay_first_therm_sweep(d, tag, torch.device("cpu"))
    assert dH.dtype == np.dtype(DTYPES[tag])
    assert dH.shape == accepted.shape == (CHAINS,)
    np.testing.assert_allclose(dH, np.asarray(jseg.dH)[0], rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(accepted, np.asarray(jseg.accepted)[0])
    if tag == "f32":
        up, _ = c5.replay_first_therm_sweep(d, tag, torch.device("cpu"),
                                            torch.float64)
        assert up.dtype == np.float64
        assert np.abs(dH - up).max() < 1e-3


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write()
    print(f"wrote {DATA} ({os.path.getsize(DATA)} bytes)")
