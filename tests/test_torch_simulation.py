"""Port parity for the single-run driver, ``drivers/simulation.run_simulation``,
float64 on the CPU at 4×4: the complex path and the tracked real path with
the host float64 readout, each against the JAX package's run of the same
config with its initial ensemble and its draws replayed.  The CSV headers
are byte-equal; every row agrees with the JAX row to the CSV's six
significant digits (rtol 1e-5), with equal Sweep, Chain and Accepted
columns.  Then: a resume keeps the earlier rows byte-identical and
continues the trajectory exactly, ``run_scan_serial`` skips a finished
point, and ``drivers/run_local`` runs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.drivers.simulation import run_simulation as jrun
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.utils.config import RunConfig as JConfig
from dwavehmc_tpu_torch.drivers import run_local
from dwavehmc_tpu_torch.drivers.scan import run_scan_serial
from dwavehmc_tpu_torch.drivers.simulation import run_simulation
from dwavehmc_tpu_torch.utils.carry import state_from_numpy
from dwavehmc_tpu_torch.utils.config import RunConfig
from dwavehmc_tpu_torch.utils.io import SpectraBinStore

torch.set_num_threads(2)

BASE = dict(Lx=4, Ly=4, W=0.5, n_imp=0.25, beta=5.0, J=1.0,
            eta=0.2, domega=0.2, omega_max=1.0,
            n_therm=5, n_measure=4, Nt_therm_init=4, Nt_measure=4,
            measure_transport_freq=2, bin_size=1, n_chains=2, seed=1,
            dtype="float64", verbose=False, checkpoint_freq=2)
PATHS = {
    "complex": dict(path="complex"),
    "host": dict(path="real", eigh_mode="tracked", metropolis_readout="host"),
}


class JaxDraws:
    """The JAX run's draws, sweep by sweep: each chain's key splits into
    (key', k_mom, k_acc) per sweep."""

    def __init__(self, keys, n_sites: int):
        self.keys, self.n_sites = keys, n_sites

    def __call__(self, n):
        normals, uniforms = [], []
        for _ in range(n):
            ks = jax.vmap(lambda k: jax.random.split(k, 3))(self.keys)
            self.keys = ks[:, 0]
            normals.append(jax.vmap(lambda k: jax.random.normal(
                k, (2, self.n_sites, 2), jnp.float64))(ks[:, 1]))
            uniforms.append(jax.vmap(lambda k: jax.random.uniform(
                k, (), jnp.float32))(ks[:, 2]))
        return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


def _jax_initial(jcfg):
    """The initial ensemble JAX's ``run_simulation`` draws for ``jcfg``."""
    lat, params = jcfg.lattice(), jcfg.params()
    if jcfg.resolved_path() == "complex":
        return jens.init_ensemble(lat, params, jax.random.PRNGKey(jcfg.seed),
                                  jcfg.n_chains, dtype=jnp.float64,
                                  n_imp=jcfg.n_imp)
    return jens.init_ensemble_real(lat, params,
                                   jax.random.PRNGKey(jcfg.seed),
                                   jcfg.n_chains, dtype=jnp.float64,
                                   n_imp=jcfg.n_imp,
                                   exact_solver=jcfg.exact_solver)


def _read(path):
    with open(path) as f:
        return f.read()


def _rows(path):
    lines = _read(path).splitlines()
    return lines[0], np.array([[float(x) for x in ln.split(",")]
                               for ln in lines[1:]])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_simulation_matches_jax(tmp_path, path):
    kw = dict(BASE, **PATHS[path])
    jcfg = JConfig(**kw, out_dir=str(tmp_path / "jax"))
    jout = jrun(jcfg)
    js = _jax_initial(jcfg)
    draws = JaxDraws(js.key, jcfg.lattice().n_sites)
    tcfg = RunConfig(**kw, out_dir=str(tmp_path / "torch"))
    tout = run_simulation(
        tcfg, device="cpu", draws=draws,
        states=state_from_numpy({k: np.asarray(v) for k, v in
                                 js._asdict().items()}, device="cpu"))
    assert tout["sweeps"] == jout["sweeps"] == 4
    assert tout["acceptance"] == jout["acceptance"]
    for name, n_rows in (("observables.csv", 8), ("transport.csv", 4)):
        jh, jrows = _rows(os.path.join(jcfg.out_dir, name))
        th, trows = _rows(os.path.join(tcfg.out_dir, name))
        assert th == jh
        assert trows.shape == jrows.shape == (n_rows, len(jh.split(",")))
        n_exact = 4 if name == "observables.csv" else 2   # Sweep, Chain, Acc
        np.testing.assert_array_equal(trows[:, :n_exact], jrows[:, :n_exact])
        np.testing.assert_allclose(trows, jrows, rtol=1e-5, atol=0.0,
                                   err_msg=name)
    jmeta, jbins = SpectraBinStore.load_bins(
        os.path.join(jcfg.out_dir, "spectra_bins.npz"))
    tmeta, tbins = SpectraBinStore.load_bins(
        os.path.join(tcfg.out_dir, "spectra_bins.npz"))
    assert sorted(tbins) == sorted(jbins) == [2, 4]
    assert sorted(tmeta) == sorted(jmeta)
    for s in jbins:
        for k, v in jbins[s].items():
            np.testing.assert_allclose(tbins[s][k], v, rtol=1e-9, atol=1e-12,
                                       err_msg=f"bin {s} {k}")


def test_resume_keeps_rows_and_continues_the_trajectory(tmp_path):
    kw = dict(BASE, path="complex", n_chains=1, measure_transport_freq=1,
              bin_size=2, checkpoint_freq=2)
    full = RunConfig(**kw, out_dir=str(tmp_path / "full"))
    run_simulation(full, device="cpu")
    part = RunConfig(**dict(kw, n_measure=3), out_dir=str(tmp_path / "part"))
    run_simulation(part, device="cpu")         # checkpoints at 2 and 3
    pre = {n: _read(os.path.join(part.out_dir, n))
           for n in ("observables.csv", "transport.csv")}
    # resume from the sweep-3 checkpoint (odd: a partial spectra bin)
    out = run_simulation(dataclasses.replace(part, n_measure=4, resume=True),
                         device="cpu")
    assert out["sweeps"] == 4
    for n, txt in pre.items():
        new = _read(os.path.join(part.out_dir, n))
        assert new.startswith(txt)
        assert len(new.splitlines()) == 1 + 4
    with np.load(os.path.join(full.out_dir, "checkpoint.npz")) as a, \
            np.load(os.path.join(part.out_dir, "checkpoint.npz")) as b:
        assert int(a["sweep_idx"]) == int(b["sweep_idx"]) == 4
        np.testing.assert_allclose(a["delta"], b["delta"], atol=1e-12)
    _, bins = SpectraBinStore.load_bins(
        os.path.join(part.out_dir, "spectra_bins.npz"))
    assert sorted(bins) == [2, 4] and int(bins[4]["count"]) == 2
    assert _read(os.path.join(full.out_dir, "observables.csv")) == _read(
        os.path.join(part.out_dir, "observables.csv"))


def test_run_scan_serial_skips_a_finished_point(tmp_path):
    cfg = RunConfig(**dict(BASE, path="complex", n_chains=1, n_therm=2,
                           n_measure=2, checkpoint_freq=0),
                    out_dir=str(tmp_path / "serial"))
    first = run_scan_serial(cfg, [0.5, 2.0], device="cpu")
    assert [os.path.basename(r["out_dir"]) for r in first] == ["T_0.5",
                                                                "T_2"]
    assert not any(r.get("skipped") for r in first)
    stamp = {r["out_dir"]: _read(os.path.join(r["out_dir"],
                                              "observables.csv"))
             for r in first}
    again = run_scan_serial(dataclasses.replace(cfg, resume=True),
                            [0.5, 2.0, 1.0], device="cpu")
    assert [bool(r.get("skipped")) for r in again] == [True, True, False]
    for d, txt in stamp.items():
        assert _read(os.path.join(d, "observables.csv")) == txt


def test_run_local_on_cpu(tmp_path, capsys):
    out = run_local.main(["--L", "4", "--sweeps", "2", "--dtype", "float64",
                          "--path", "complex", "--device", "cpu",
                          "--out_dir", str(tmp_path / "local")])
    assert out["sweeps"] == 2
    assert "acceptance" in capsys.readouterr().out
