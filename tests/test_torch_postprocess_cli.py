"""The port's post-processing CLIs (``drivers/process_spectra.py``,
``summarize_scan.py``, ``merge_scan_points.py``, run as ``python -m``
subprocesses) against the JAX scripts (``scripts/*.py``, loaded with
``importlib``) on copies of one 4×4 scan directory that the port's
``batch_scan_T --device cpu`` writes: every file they write must be equal,
byte for byte.  Then the quick-tier gate ``utils/quickcheck.py``: the
switch, a red tier, rank 0 only, and its place before the scan entry
points' work."""

import filecmp
import importlib.util
import os
import runpy
import shutil
import subprocess
import sys

import pytest
import torch

from dwavehmc_tpu_torch.drivers import batch_scan_T
from dwavehmc_tpu_torch.utils import quickcheck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN = ["--device", "cpu", "--Lx", "4", "--Ly", "4", "--n_T", "3",
        "--T_min", "0.5", "--T_max", "2", "--replicas", "1", "--n_therm", "2",
        "--n_measure", "3", "--Nt_therm_init", "3", "--Nt_measure", "3",
        "--anneal_stages", "0", "--meas_probe_sweeps", "0", "--bin_size", "1",
        "--dtype", "float64", "--verbose", "false"]


def jax_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def port_cli(name, argv):
    out = subprocess.run(
        [sys.executable, "-m", f"dwavehmc_tpu_torch.drivers.{name}", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr
    return out.stdout


def assert_same_tree(a, b):
    """Every file under ``a`` and ``b`` equal, byte for byte."""
    def files(top):
        return sorted(os.path.relpath(os.path.join(d, f), top)
                      for d, _, fs in os.walk(top) for f in fs)

    names = files(a)
    assert files(b) == names
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """(target, donor): two 4×4 scans of the same 3 T points from other
    seeds; the donor keeps 2 of them."""
    root = tmp_path_factory.mktemp("cli")
    target, donor = str(root / "target"), str(root / "donor")
    batch_scan_T.main(SCAN + ["--out_dir", target])
    batch_scan_T.main(SCAN + ["--seed", "7", "--out_dir", donor])
    shutil.rmtree(os.path.join(donor, "T_2"))
    return target, donor


def copies(src, tmp_path, *names):
    out = []
    for n in names:
        shutil.copytree(src, tmp_path / n)
        out.append(str(tmp_path / n))
    return out


def test_process_spectra_batch_matches_jax(scans, tmp_path, monkeypatch,
                                           capsys):
    j, t = copies(scans[0], tmp_path, "jax", "port")
    jax_script("process_spectra", [j, "--batch", "--pattern", "T_*"],
               monkeypatch)
    jax_out = capsys.readouterr().out
    port_out = port_cli("process_spectra", [t, "--batch", "--pattern", "T_*"])
    assert port_out.replace(t, "ROOT") == jax_out.replace(j, "ROOT")
    assert "FAILED" not in port_out
    names = assert_same_tree(j, t)
    assert sum("processed_" in n for n in names) == 3 * 4


def test_process_spectra_one_run_matches_jax(scans, tmp_path, monkeypatch,
                                             capsys):
    j, t = copies(os.path.join(scans[0], "T_0.5"), tmp_path, "jax", "port")
    jax_script("process_spectra", [j], monkeypatch)
    jax_out = capsys.readouterr().out
    port_out = port_cli("process_spectra", [t])
    assert port_out.replace(t, "RUN") == jax_out.replace(j, "RUN")
    assert "3 bins" in port_out
    assert_same_tree(j, t)


def test_summarize_scan_matches_jax(scans, tmp_path, monkeypatch):
    j, t = copies(scans[0], tmp_path, "jax", "port")
    for d in (j, t):
        os.remove(os.path.join(d, "summary_all.csv"))
    jax_script("summarize_scan", [j, "--prefix", "T_", "--name", "T"],
               monkeypatch)
    port_cli("summarize_scan", [t, "--prefix", "T_", "--name", "T"])
    assert_same_tree(j, t)
    with open(os.path.join(t, "summary_all.csv")) as f:
        assert len(f.read().splitlines()) == 1 + 3


def test_merge_scan_points_matches_jax(scans, tmp_path, monkeypatch):
    """The donor's 2 points replace the target's (its processed spectra
    dropped with a warning), the summary is regenerated, the health file
    merged and the provenance written, as the JAX script does."""
    target, donor = scans
    j, t = copies(target, tmp_path, "jax", "port")
    for d in (j, t):
        port_cli("process_spectra", [os.path.join(d, "T_0.5")])
    args = ["--donor", donor, "--param", "T", "--note", "re-run, seed 7"]
    jax_script("merge_scan_points", ["--target", j, *args], monkeypatch)
    port_cli("merge_scan_points", ["--target", t, *args])
    names = assert_same_tree(j, t)
    assert "provenance.json" in names
    assert not any(n.startswith("T_0.5/processed_") for n in names)
    for p in ("T_0.5", "T_1"):
        assert filecmp.cmp(os.path.join(t, p, "observables.csv"),
                           os.path.join(donor, p, "observables.csv"),
                           shallow=False)
    assert filecmp.cmp(os.path.join(t, "T_2", "observables.csv"),
                       os.path.join(target, "T_2", "observables.csv"),
                       shallow=False)


# --- the quick-tier gate ------------------------------------------------------

@pytest.fixture
def runs(monkeypatch):
    """The gate's pytest subprocesses, each answered with ``rc[0]``."""
    calls, rc = [], [0]

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, rc[0])

    monkeypatch.setattr(quickcheck.subprocess, "run", fake_run)
    for k in ("SKIP_QUICK_TESTS", "RANK"):
        monkeypatch.delenv(k, raising=False)
    return calls, rc


def test_quick_suite_runs_the_cuda_tier_without_conftest(runs):
    calls, _ = runs
    quickcheck.run_quick_suite()
    (cmd, kw), = calls
    assert cmd[:3] == [sys.executable, "-m", "pytest"]
    assert "--noconftest" in cmd and "-x" in cmd
    assert cmd[-2:] == ["tests/test_torch_cuda.py",
                        "tests/test_torch_lorentzian_launch.py"]
    assert kw["cwd"] == REPO
    assert all(os.path.exists(os.path.join(REPO, f))
               for f in quickcheck.QUICK_TESTS)


def test_quick_suite_switch_skips_it(runs, monkeypatch):
    calls, _ = runs
    monkeypatch.setenv("SKIP_QUICK_TESTS", "1")
    quickcheck.run_quick_suite()
    assert calls == []


def test_red_quick_suite_exits(runs):
    calls, rc = runs
    rc[0] = 1
    with pytest.raises(SystemExit, match="quick test tier FAILED"):
        quickcheck.run_quick_suite()
    assert len(calls) == 1


@pytest.mark.parametrize("rank,runs_it", [(None, True), ("0", True),
                                          ("1", False), ("3", False)])
def test_only_rank_zero_runs_the_quick_suite(runs, monkeypatch, rank,
                                             runs_it):
    calls, _ = runs
    if rank is not None:
        monkeypatch.setenv("RANK", rank)
    quickcheck.run_quick_suite()
    assert len(calls) == int(runs_it)


@pytest.mark.parametrize("module", ["batch_scan_T", "batch_scan_beta"])
def test_scan_entry_points_gate_before_any_work(module, monkeypatch,
                                                capsys):
    """Run as a program, the entry point calls the gate first: a red tier
    stops it before its arguments are even parsed.  ``main(argv)`` does not
    call it."""
    events = []

    def red():
        events.append("gate")
        raise SystemExit("red")

    monkeypatch.setattr(quickcheck, "run_quick_suite", red)
    monkeypatch.setattr(sys, "argv", [module, "--help"])
    monkeypatch.delitem(sys.modules, f"dwavehmc_tpu_torch.drivers.{module}",
                        raising=False)
    with pytest.raises(SystemExit, match="red"):
        runpy.run_module(f"dwavehmc_tpu_torch.drivers.{module}",
                         run_name="__main__")
    assert events == ["gate"]
    assert "usage" not in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        batch_scan_T.main(["--help"])
    assert e.value.code == 0 and events == ["gate"]
