"""Port parity for the S3 and S4 benchmarks, float64 on the CPU: the JAX
scripts themselves (``scripts/benchmark_clean.py``,
``scripts/benchmark_beta_scan.py``, loaded with ``importlib`` and run with a
patched ``sys.argv``) against the port's drivers under the JAX chain's
draws, replayed.  S3: equal accepts and |Δ_global| per sweep within 1e-10;
S4: equal CSVs.  Then the full ``--fast`` S3 gate on the CPU, and the real
path's K1 schedule."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dwavehmc_tpu.models import observables as jobs
from dwavehmc_tpu_torch.drivers import benchmark_beta_scan as s4
from dwavehmc_tpu_torch.drivers import benchmark_clean as s3
from dwavehmc_tpu_torch.ops import tracked_eigh as tte

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 4
N = L * L


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain_draws(seed, n_sweeps):
    """The per-sweep draws of the JAX scripts' one chain: its key is the
    third split of PRNGKey(seed), and every sweep splits (key', k_mom,
    k_acc).  Normals (n_sweeps, 1, 2, N, 2), uniforms (n_sweeps, 1)."""
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        key, k_mom, k_acc = jax.random.split(key, 3)
        normals.append(jax.random.normal(k_mom, (1, 2, N, 2), jnp.float64))
        uniforms.append(jax.random.uniform(k_acc, (1,), jnp.float32))
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


S3_ARGS = ["--L", str(L), "--beta", "40", "--J", "1.6", "--n_therm", "3",
           "--n_measure", "8", "--Nt_therm", "6", "--Nt_measure", "2",
           "--seed", "4"]


def test_clean_loop_matches_the_jax_script(monkeypatch, capsys):
    """S3 at 4×4 on the complex path: the port's loop under the JAX draws
    takes the JAX script's accept decisions and its |Δ_global| per sweep,
    and prints its results block."""
    seen = []
    measure = jobs.measure_observables

    def recorder(lat, params, state):
        obs = measure(lat, params, state)
        seen.append((float(obs.delta_global), np.asarray(state.delta)))
        return obs

    monkeypatch.setattr(jobs, "measure_observables", recorder)
    monkeypatch.setattr(sys, "argv", ["benchmark_clean.py", *S3_ARGS])
    jax_rc = jax_script("benchmark_clean").main()
    jax_out = capsys.readouterr().out.splitlines()

    normals, uniforms = chain_draws(4, 3 + 8)
    lines = []
    res = s3.benchmark(s3.parser().parse_args(S3_ARGS + ["--device", "cpu"]),
                       normals=normals, uniforms=uniforms, log=lines.append)
    run = res["run"]
    np.testing.assert_allclose(run.delta_global, [g for g, _ in seen],
                               rtol=1e-10, atol=1e-10)
    # a rejected sweep leaves Δ as it was; the script prints the count
    moved = [bool(np.any(b[1] != a[1])) for a, b in zip(seen, seen[1:])]
    assert list(run.accepted[1:]) == moved
    acc_line = [ln for ln in jax_out if ln.startswith("Acceptance")]
    assert acc_line == [f"Acceptance      : {run.accepted.mean():.2f}"]
    assert 0 < run.accepted.sum() < len(run.accepted)    # both decisions
    for key in ("HMC <|", "BCS RHS", "Difference", "Acceptance", ">>>"):
        assert ([ln for ln in lines if ln.startswith(key)]
                == [ln for ln in jax_out if ln.startswith(key)])
    assert (0 if res["passed"] else 1) == jax_rc


def test_beta_scan_csv_matches_the_jax_script(monkeypatch, tmp_path):
    """S4 at 4×4, 2 β points, warm-started from one to the next: the port's
    CSV under the JAX draws equals the JAX script's, byte for byte."""
    args = ["--L", str(L), "--n_beta", "2", "--beta_min", "2",
            "--beta_max", "60", "--n_therm", "2", "--n_measure", "4",
            "--Nt", "4", "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["benchmark_beta_scan.py", *args,
                                      "--out", str(tmp_path / "jax.csv")])
    jax_script("benchmark_beta_scan").main()

    normals, uniforms = chain_draws(1, 2 * (2 + 4))
    rows = s4.beta_scan(s4.parser().parse_args(
        args + ["--device", "cpu", "--out", str(tmp_path / "port.csv")]),
        normals=normals, uniforms=uniforms)
    port = (tmp_path / "port.csv").read_text()
    assert port == (tmp_path / "jax.csv").read_text()
    assert port.splitlines()[0] == s4.CSV_HEADER
    assert len(rows) == 2 and all(np.isfinite(rows).ravel())


def test_fast_gate_passes_on_the_cpu(capsys):
    """The full ``--fast`` S3 gate (8×8, β = 100, 40 + 60 sweeps, float64
    complex path, seed 0) passes, with the measurement acceptance above
    0.5 as ``tests/test_observables.py`` asks of the same run."""
    assert s3.main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ">>> Benchmark 1 Passed!" in out
    acc = float(out.split("Acceptance      : ")[1].split()[0])
    assert acc > 0.5


def test_real_tracked_path_follows_the_k1_schedule(monkeypatch):
    """``--path real --eigh_mode tracked``: every leapfrog step makes 6
    tracked rotations, each one K1 call, and the run stays finite."""
    calls = []
    rot = tte.rotation_s_parts

    def counted(*a):
        calls.append(a[0].shape)
        return rot(*a)

    monkeypatch.setattr(tte, "rotation_s_parts", counted)
    res = s3.benchmark(s3.parser().parse_args(
        ["--L", "4", "--beta", "20", "--n_therm", "2", "--n_measure", "3",
         "--Nt_therm", "5", "--Nt_measure", "3", "--path", "real",
         "--eigh_mode", "tracked", "--dtype", "float32", "--device", "cpu"]),
        log=lambda s: None)
    assert len(calls) == 6 * (2 * 5 + 3 * 3)
    assert set(calls) == {(1, 2 * N, 2 * N)}
    assert np.all(np.isfinite(res["run"].delta_global))
    assert np.isfinite(res["diff"])
