"""The port's ρ_s-dip audit statistics and plots, on the CPU:

* ``drivers/audit_rhos_dip.point_stats`` on the committed
  ``examples/beta_scan_full_12x12`` equal to the means, SEMs and acceptance
  computed here from its CSVs; ``compare_points`` applies the JAX script's
  agreement rule (the artifact against itself agrees at every point);
* ``drivers/plot_results`` on a tiny scan root written by the port
  (``batch_scan_T --device cpu`` at 4×4, processed and summarized): the
  same set of files as ``scripts/plot_results.py`` on the same root, the
  same power-law fit; without matplotlib it raises one ``ImportError``
  that says so.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from dwavehmc_tpu_torch.drivers import audit_rhos_dip as audit
from dwavehmc_tpu_torch.drivers import batch_scan_T
from dwavehmc_tpu_torch.drivers import plot_results as plots
from dwavehmc_tpu_torch.drivers.postprocess import (
    batch_process_spectra,
    summarize_scan,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROD = os.path.join(REPO, "examples", "beta_scan_full_12x12")


def columns(path):
    data = np.genfromtxt(path, delimiter=",", names=True)
    return {k: data[k] for k in data.dtype.names}


@pytest.mark.parametrize("beta", audit.BETAS)
def test_point_stats_on_the_committed_beta_scan(beta):
    d = os.path.join(PROD, f"beta_{beta:.6g}")
    tr = columns(os.path.join(d, "transport.csv"))
    obs = columns(os.path.join(d, "observables.csv"))
    rho, dc = tr["Superfluid_Stiffness"], tr["DC_Conductivity"]
    n = len(rho)
    got = audit.point_stats(PROD, beta)
    assert got["n"] == n
    np.testing.assert_allclose(got["rho_s"], rho.sum() / n, rtol=1e-12)
    np.testing.assert_allclose(
        got["rho_s_sem"],
        np.sqrt(((rho - rho.mean()) ** 2).sum() / (n - 1) / n), rtol=1e-12)
    np.testing.assert_allclose(got["dc"], dc.sum() / n, rtol=1e-12)
    np.testing.assert_allclose(
        got["dc_sem"],
        np.sqrt(((dc - dc.mean()) ** 2).sum() / (n - 1) / n), rtol=1e-12)
    np.testing.assert_allclose(got["acceptance"], obs["Accepted"].mean(),
                               rtol=1e-12)


def test_agreement_rule_on_the_artifact_itself():
    rep = audit.compare_points(PROD, PROD, log=lambda m: None)
    assert rep["dip_is_physics"] is True
    assert sorted(rep["points"]) == sorted(f"beta_{b:.6g}"
                                           for b in audit.BETAS)
    for p in rep["points"].values():
        assert p["rho_s_gap"] == 0.0 and p["same_sign"] and p["agree"]


SCAN = ["--device", "cpu", "--Lx", "4", "--Ly", "4", "--n_T", "3",
        "--T_min", "0.5", "--T_max", "20", "--replicas", "1", "--n_therm",
        "2", "--n_measure", "3", "--Nt_therm_init", "3", "--Nt_measure", "3",
        "--anneal_stages", "0", "--meas_probe_sweeps", "0", "--bin_size",
        "1", "--dtype", "float64", "--verbose", "false"]


def files(top):
    return sorted(os.listdir(top))


def test_plots_match_the_jax_script(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "scan")
    batch_scan_T.main(SCAN + ["--out_dir", root])
    assert not batch_process_spectra(root, "T_*")["failed"]
    summarize_scan(root, "T_")
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_out.mkdir()
    port_out.mkdir()

    monkeypatch.setattr(sys, "argv", ["plot_results.py", root, "--out",
                                      str(jax_out)])
    spec = importlib.util.spec_from_file_location(
        "jax_plot_results", os.path.join(REPO, "scripts", "plot_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main()
    want = capsys.readouterr().out.splitlines()
    assert plots.main([root, "--out", str(port_out)]) == str(port_out)
    got = capsys.readouterr().out.splitlines()

    names = files(jax_out)
    assert files(port_out) == names
    assert {"sigma_omega.png", "dos.png", "stiffness.png",
            "order_params.png"} <= set(names)
    assert sum(n.startswith("ak0_T_") for n in names) == 3
    assert got[:-1] == want[:-1]
    assert got[-1] == f"plots written to {port_out}"
    if "powerlaw_fit.json" in names:
        j = json.loads((jax_out / "powerlaw_fit.json").read_text())
        p = json.loads((port_out / "powerlaw_fit.json").read_text())
        assert p == j


def test_plots_need_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        plots.pyplot()
