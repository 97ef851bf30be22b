"""The port's microbenchmarks and the ρ_s inspection against the JAX
scripts, on the CPU:

* ``drivers/bench_forces`` at 4×4 in float64 on the JAX ensemble's
  eigenpairs: the row contraction and the matmul-diagonal formulation
  within 1e-10 of each other, and ``pairing_correlations`` within 1e-10 of
  JAX's; the CLI prints ``OK`` (float64 and float32);
* ``drivers/bench_kernels`` at L = 4: the JAX script's row names in its
  order, none ``FAILED``; a failing row makes the run exit nonzero;
* ``drivers/debug_transport`` at L = 4, float64: the printed lines equal
  to the JAX script's stdout (the Drude difference, a round-off, within
  1e-12 in both).
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.ops.forces import pairing_correlations as jpairing
from dwavehmc_tpu.parallel.ensemble import init_ensemble as jinit_ensemble
from dwavehmc_tpu_torch.drivers import bench_forces as bf
from dwavehmc_tpu_torch.drivers import bench_kernels as bk
from dwavehmc_tpu_torch.drivers import debug_transport as dbg
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.ops.forces import pairing_correlations

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_script(name, argv, monkeypatch, capsys):
    """The JAX script's stdout lines for ``argv`` on the CPU."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv,
                                      "--platform", "cpu"])
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def test_bench_forces_formulations_on_the_jax_ensemble():
    jp = jmake_params(W=1.0, n_imp=0.05, beta=bf.BETA, J=0.8,
                      dtype=jnp.float64)
    js = jinit_ensemble(JLat(4, 4), jp, jax.random.PRNGKey(0), 2,
                        dtype=jnp.float64, n_imp=0.05)
    evals = torch.as_tensor(np.array(js.evals))
    evecs = torch.as_tensor(np.array(js.evecs))
    lat = LatticeSpec(4, 4)
    beta = torch.tensor(bf.BETA, dtype=torch.float64)
    diff, tol = bf.equivalence(lat, evals, evecs, beta)
    assert diff <= 1e-10 and tol == 1e-10
    want = np.asarray(jax.vmap(lambda e, U: jpairing(JLat(4, 4), e, U,
                                                     bf.BETA))(js.evals,
                                                               js.evecs))
    got = pairing_correlations(lat, evals, evecs, beta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bench_forces_cli_prints_ok(dtype):
    lines = []
    assert bf.bench(bf.parser().parse_args(
        ["--device", "cpu", "--L", "4", "--batch", "2", "--reps", "1",
         "--dtype", dtype]), out=lines.append)
    assert lines[0].startswith("kernel equivalence:")
    assert lines[0].endswith(" OK")
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == [
        "row-contract O(N²)", "matmul-diag O(N³)"]


ARGS = ["--L", "4", "--batch", "2", "--reps", "1"]


def row_names(lines):
    return [ln.split(":")[0].strip() for ln in lines[1:]]


def test_bench_kernels_rows_match_the_jax_script(monkeypatch, capsys):
    want = run_jax_script("bench_kernels", ARGS, monkeypatch, capsys)
    lines = []
    failed = bk.bench(bk.parser().parse_args(ARGS + ["--device", "cpu"]),
                      out=lines.append)
    assert failed == []
    assert row_names(lines) == row_names(want)
    assert not any("FAILED" in ln or "skipped" in ln for ln in lines)
    assert lines[0].startswith("device=cpu L=4 (2N=32) batch=2")

    skipped = []
    bk.bench(bk.parser().parse_args(ARGS + ["--device", "cpu", "--skip",
                                            "refine", "complex"]),
             out=skipped.append)
    assert "exact eigh (complex 2N)" not in row_names(skipped)
    assert sum("skipped" in ln for ln in skipped) == 3


def test_bench_kernels_exits_nonzero_on_a_failed_row(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(bk, "current_J2_real", broken)
    with pytest.raises(SystemExit) as exc:
        bk.main(ARGS + ["--device", "cpu", "--skip", "refine"])
    assert "transport |J_mn|^2" in str(exc.value)


@pytest.mark.parametrize("extra", [[], ["--delta", "0"]])
def test_debug_transport_prints_the_jax_lines(extra, monkeypatch, capsys):
    argv = ["--L", "4"] + extra
    want = run_jax_script("debug_transport", argv, monkeypatch, capsys)
    lines = []
    terms = dbg.inspect(dbg.parser().parse_args(argv + ["--device", "cpu"]),
                        out=lines.append)
    assert len(lines) == len(want) == (5 if extra else 4)
    assert lines[:4] == want[:4]
    if extra:
        head, wdiff = want[4].split("(diff ")
        assert lines[4].split("(diff ")[0] == head
        assert float(wdiff.rstrip(")")) <= 1e-12
        assert terms["drude_diff"] <= 1e-12
