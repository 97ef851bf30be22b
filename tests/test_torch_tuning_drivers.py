"""Port parity for the tuning and benchmark drivers, on the CPU: the JAX
scripts themselves (loaded with ``importlib`` and run with a patched
``sys.argv`` or environment) against the port's drivers on the same draws.

* ``probe_beta_dt`` at 4×4, float32: its record (mean and median |dH| and
  acceptance per dt scale) within 1e-4 of the JAX script's, keys equal;
* ``tune_Nt_efficiency`` at 4×4, float64: the printed table line for line;
* ``bench_ph_eigh`` at 3×3: the port's race on the JAX script's batch gives
  its keys and an eigenvalue error and residual as small;
* ``ab_polish``: the same variants, and its report's keys on a tiny run.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel.ensemble import init_ensemble_real as jinit_ens
from dwavehmc_tpu.sampler.hmc import init_chain_state as jinit_chain
from dwavehmc_tpu_torch.drivers import ab_polish as ab
from dwavehmc_tpu_torch.drivers import bench_ph_eigh as bench
from dwavehmc_tpu_torch.drivers import probe_beta_dt as probe
from dwavehmc_tpu_torch.drivers import tune_Nt_efficiency as tune
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.sampler.hmc import init_chain_state
from dwavehmc_tpu_torch.utils.carry import state_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_draws(keys, n_sweeps, n_sites, dtype):
    """(keys after, normals (n, B, 2, N, 2), uniforms (n, B)) of chains
    whose keys split (key', k_mom, k_acc) every sweep."""
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        normals.append(jax.vmap(lambda k: jax.random.normal(
            k, (2, n_sites, 2), dtype))(ks[:, 1]))
        uniforms.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32))(ks[:, 2]))
    return keys, np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


PROBE_ENV = dict(PROBE_BETA="20", PROBE_L="4", PROBE_B="2", PROBE_NT="3")


def test_probe_matches_the_jax_script(monkeypatch, tmp_path, capsys):
    for k, v in PROBE_ENV.items():
        monkeypatch.setenv(k, v)
    # the JAX script writes examples/beta_dt_probe.json under the cwd
    (tmp_path / "examples").mkdir()
    monkeypatch.chdir(tmp_path)
    jax_script("probe_beta_dt").main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert want == json.loads(
        (tmp_path / "examples" / "beta_dt_probe.json").read_text())

    kn = probe.knobs()
    jp = jmake_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.0,
                      beta=kn["beta"], J=0.8, mass=1.0, dtype=jnp.float32)
    js = jinit_ens(JLat(4, 4), jp, jax.random.PRNGKey(0), kn["b"],
                   dtype=jnp.float32, n_imp=0.0)
    keys, *therm = split_draws(js.key, 10, 16, jnp.float32)
    _, *draws = split_draws(keys, 8, 16, jnp.float32)
    states = state_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    got = probe.probe(kn, "cpu", states=states, therm_draws=therm,
                      probe_draws=draws, log=lambda s: None)

    assert sorted(got) == sorted(want)
    for k in ("beta", "L", "batch", "Nt", "dt0"):
        assert got[k] == want[k]
    for a, b in zip(got["points"], want["points"]):
        assert sorted(a) == sorted(b)
        assert a["dt_scale"] == b["dt_scale"] and a["acc"] == b["acc"]
        for k in ("mean_absdH", "med_absdH"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["ratio_dt0_over_quarter"],
                               want["ratio_dt0_over_quarter"], rtol=1e-2)


TUNE_ARGS = ["--L", "4", "--Nt_list", "2", "4", "--n_sweeps", "4",
             "--n_therm", "2", "--dtype", "float64", "--seed", "3"]


def test_tune_table_matches_the_jax_script(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["tune_Nt_efficiency.py", *TUNE_ARGS,
                                      "--platform", "cpu"])
    jax_script("tune_Nt_efficiency").main()
    want = capsys.readouterr().out.splitlines()

    ns = tune.parser().parse_args(TUNE_ARGS + ["--device", "cpu"])
    jp = jmake_params(W=ns.W, n_imp=ns.n_imp, beta=ns.beta, J=ns.J,
                      mass=ns.mass, dtype=jnp.float64)
    js = jinit_chain(JLat(4, 4), jp, jax.random.PRNGKey(ns.seed),
                     dtype=jnp.float64, n_imp=ns.n_imp)
    _, normals, uniforms = split_draws(js.key[None],
                                       ns.n_therm + ns.n_sweeps, 16,
                                       jnp.float64)
    p = make_params(W=ns.W, n_imp=ns.n_imp, beta=ns.beta, J=ns.J,
                    mass=ns.mass, dtype=torch.float64, device="cpu")
    state0 = init_chain_state(
        TLat(4, 4), p, 1, dtype=torch.float64,
        delta0=torch.as_tensor(np.array(js.delta))[None],
        disorder=torch.as_tensor(np.array(js.disorder))[None], device="cpu")
    lines = []
    rows, best = tune.tune(ns, state0=state0, draws=(normals, uniforms),
                           log=lines.append)
    assert lines == want
    assert [r[0] for r in rows] == [2, 4] and best[0] in (2, 4)
    # both decisions were taken somewhere, so the count was tested
    assert any(0 < r[2] < 1 for r in rows) or len({r[2] for r in rows}) > 1


def test_bench_ph_eigh_record_matches_the_jax_script(monkeypatch, capsys):
    args = ["--L", "3", "--batch", "2", "--reps", "1"]
    monkeypatch.setattr(sys, "argv", ["bench_ph_eigh.py", *args])
    mod = jax_script("bench_ph_eigh")
    mod.main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])

    M = torch.as_tensor(np.array(mod.build_batch(3, 2)), dtype=torch.float32)
    ns = bench.parser().parse_args(args + ["--device", "cpu"])
    got, (w, _, _) = bench.race(M, ns, log=lambda s: None)
    assert sorted(got) == sorted(want)
    for k in ("shape", "n_lift", "orth", "lift_prec", "floor"):
        assert got[k] == want[k]
    assert got["eval_err"] <= max(4.0 * want["eval_err"], 1e-5)
    assert got["max_res_colnorm"] <= max(4.0 * want["max_res_colnorm"], 1e-4)
    # the port's own batch builder: float32 embeddings of the same shape
    Mp = bench.build_batch(3, 2, torch.Generator().manual_seed(0), "cpu")
    assert Mp.shape == M.shape and Mp.dtype == torch.float32
    assert torch.equal(Mp, Mp.mT)


def test_ab_polish_variants_and_report(monkeypatch, tmp_path, capsys):
    jmod = jax_script("ab_polish")
    assert ab.CONFIGS == jmod.CONFIGS
    for k, v in dict(AB_L="3", AB_BATCH="2", AB_THERM="1", AB_PAIRED="1",
                     AB_SWEEPS="2", AB_K="2").items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "polish_ab.json"
    rep = ab.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))
    assert sorted(rep) == ["config", "device", "results"]
    assert [(r["polish_iters"], r["polish_precision"],
             r["polish_correction"]) for r in rep["results"]] == ab.CONFIGS
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert sorted(last) == ["baseline_traj_per_sec", "best"]
    # on the CPU "high" is the IEEE product: the first two variants agree
    assert (rep["results"][0]["max_dH_err"]
            == rep["results"][1]["max_dH_err"])
