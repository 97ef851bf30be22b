"""Port parity for the scan entry point: ``drivers/scan.py``,
``utils/config.py``, ``drivers/postprocess.py`` and
``drivers/batch_scan_T.py`` against the JAX package.

The controllers are deterministic numpy and must equal the JAX package's
on random inputs.  The scan itself draws from a torch generator, so a 4×4
float64 scan is compared with the JAX scan of the same config by its
output schema — directory tree, file names, CSV headers, row counts,
Sweep/Chain columns, npz keys, shapes and meta, ``therm_health.json`` keys
— and the JAX package's own post-processing must read the port's output.
"""

import argparse
import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dwavehmc_tpu.drivers import postprocess as jpost
from dwavehmc_tpu.drivers import scan as jscan
from dwavehmc_tpu.utils import config as jconfig
from dwavehmc_tpu_torch.drivers import batch_scan_T
from dwavehmc_tpu_torch.drivers import postprocess as tpost
from dwavehmc_tpu_torch.drivers import scan as tscan
from dwavehmc_tpu_torch.utils import config as tconfig
from dwavehmc_tpu_torch.utils.io import OBS_HEADER

torch.set_num_threads(2)

TS = [0.5, 1.0, 0.005]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controllers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    dt0 = rng.uniform(0.01, 1.0, n)
    dts = dt0 * rng.uniform(0.03, 5.0, n)
    acc = rng.choice([0.0, 0.2, 0.5, 0.7, 0.96, 1.0], n)
    med_abs = np.where(rng.random(n) < 0.1, np.nan, rng.exponential(1.0, n))
    med = rng.normal(0.0, 1.0, n)
    for kw in ({}, {"med_absdH": med_abs}, {"med_dH": med},
               {"med_absdH": med_abs, "med_dH": med, "grow": 1.0}):
        np.testing.assert_array_equal(tscan.adapt_dts(dts, acc, dt0, **kw),
                                      jscan.adapt_dts(dts, acc, dt0, **kw))
    np.testing.assert_array_equal(tscan.chain_health(dts, acc, dt0),
                                  jscan.chain_health(dts, acc, dt0))
    acc_pt = rng.choice([0.1, 0.4, 0.7, 1.0], 12)
    assert tscan.nt_buckets(acc_pt, 7) == jscan.nt_buckets(acc_pt, 7)
    assert (tscan.DT_MIN_FACTOR, tscan.NEG_DH_GUARD, tscan.NEG_DH_BLOCK) == (
        jscan.DT_MIN_FACTOR, jscan.NEG_DH_GUARD, jscan.NEG_DH_BLOCK)
    np.testing.assert_array_equal(tscan.default_T_grid(),
                                  jscan.default_T_grid())
    np.testing.assert_array_equal(tscan.default_beta_grid(5),
                                  jscan.default_beta_grid(5))


def test_runconfig_fields_and_cli_equal_jax():
    tf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(tconfig.RunConfig)]
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jconfig.RunConfig)]
    assert tf == jf
    argv = ["--Lx", "6", "--beta", "3.5", "--eta", "0.1", "--eigh_mode",
            "tracked", "--use_pallas_s", "auto", "--resume", "true",
            "--exact_solver", "qdwh", "--anneal_stages", "2"]

    def parse(mod):
        p = mod.add_cli_args(argparse.ArgumentParser())
        return mod.from_namespace(p.parse_args(argv)).to_dict()

    assert parse(tconfig) == parse(jconfig)
    cfg = tconfig.RunConfig(Lx=6, Ly=4)
    assert cfg.lattice().n_sites == 24
    js = jconfig.RunConfig(Lx=6, Ly=4).spectral()
    assert dataclasses.astuple(cfg.spectral()) == (js.eta, js.domega,
                                                   js.omega_max)
    assert cfg.torch_dtype() == torch.float32
    assert cfg.rot_torch_dtype() is None
    assert cfg.resolved_path() == "real"
    complex_cfg = tconfig.RunConfig(path="complex")
    complex_cfg.validate()
    assert complex_cfg.resolved_path() == "complex"
    # the host readout needs the tracked real path, as in the JAX package
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError):
            mod.RunConfig(metropolis_readout="host").validate()
        mod.RunConfig(metropolis_readout="host", eigh_mode="tracked",
                      path="real").validate()
    with pytest.raises(ValueError):
        tconfig.RunConfig(exact_solver="magma").validate()


def tiny(cls, out_dir, **kw):
    base = dict(
        Lx=4, Ly=4, W=0.5, n_imp=0.25, J=1.0,
        eta=0.25, domega=0.25, omega_max=1.0,
        n_therm=5, n_measure=4, Nt_therm_init=5, Nt_measure=4,
        measure_transport_freq=2, bin_size=1, meas_probe_sweeps=0,
        n_chains=2, seed=3, dtype="float64", path="real",
        eigh_mode="tracked", exact_solver="ph",
        out_dir=out_dir, verbose=False, checkpoint_freq=2)
    base.update(kw)
    return cls(**base)


def _tree(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**"),
                                     recursive=True))


def _csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scans")
    jroot, troot = str(root / "jax"), str(root / "torch")
    jscan.run_scan_vectorized(tiny(jconfig.RunConfig, jroot), TS,
                              scan_param="T", replicas=2)
    out = tscan.run_scan_vectorized(tiny(tconfig.RunConfig, troot), TS,
                                    scan_param="T", replicas=2,
                                    device="cpu")
    return jroot, troot, out


def test_scan_writes_the_jax_layout(scans):
    jroot, troot, out = scans
    assert out["chains"] == 6 and out["ph_guard"]["solves"] > 0
    assert _tree(troot) == _tree(jroot)
    for d in sorted(glob.glob(os.path.join(jroot, "T_*"))):
        td = os.path.join(troot, os.path.basename(d))
        for name in ("observables.csv", "transport.csv"):
            jh, jrows = _csv(os.path.join(d, name))
            th, trows = _csv(os.path.join(td, name))
            assert th == jh and len(trows) == len(jrows)
            assert [r[:2] for r in trows] == [r[:2] for r in jrows]
            assert all(np.isfinite(float(x)) for r in trows for x in r[3:])
        with np.load(os.path.join(d, "spectra_bins.npz")) as jz, \
                np.load(os.path.join(td, "spectra_bins.npz")) as tz:
            assert sorted(tz.files) == sorted(jz.files)
            for k in jz.files:
                assert tz[k].shape == jz[k].shape, k
                if k.startswith("meta_"):
                    np.testing.assert_array_equal(tz[k], jz[k])
    for name in ("therm_health.json", "scan_config.json"):
        with open(os.path.join(jroot, name)) as f:
            jj = json.load(f)
        with open(os.path.join(troot, name)) as f:
            tj = json.load(f)
        assert tj.keys() == jj.keys()
        if name == "therm_health.json":
            for k in jj:
                assert tj[k].keys() == jj[k].keys()
                assert tj[k]["measurement"].keys() == \
                    jj[k]["measurement"].keys()
    with np.load(os.path.join(jroot, "scan_checkpoint.npz")) as jz, \
            np.load(os.path.join(troot, "scan_checkpoint.npz")) as tz:
        assert set(tz.files) - {"torch_generator_state"} == \
            set(jz.files) - {"key"}


def test_jax_postprocess_reads_port_scan(scans):
    _, troot, _ = scans
    res = jpost.batch_process_spectra(troot, "T_*")
    assert not res["failed"], res["failed"]
    assert len(res["processed"]) == len(TS)
    with open(jpost.summarize_scan(troot, "T_", "T")) as f:
        jsum = f.read()
    with open(tpost.summarize_scan(troot, "T_", "T")) as f:
        assert f.read() == jsum
    first = sorted(res["processed"])[0]
    assert tpost.process_spectra(first)["n_bins"] == 2


def test_scan_resume_keeps_earlier_rows(scans, tmp_path):
    _, troot, _ = scans
    root = str(tmp_path / "resume")
    shutil.copytree(troot, root)
    pre = {}
    for d in sorted(glob.glob(os.path.join(root, "T_*"))):
        for name in ("observables.csv", "transport.csv"):
            with open(os.path.join(d, name)) as f:
                pre[(d, name)] = f.read()
    cfg = tiny(tconfig.RunConfig, root, n_measure=8, resume=True)
    tscan.run_scan_vectorized(cfg, TS, scan_param="T", replicas=2,
                              device="cpu")
    with open(os.path.join(root, "scan.log")) as f:
        assert "Resumed scan at measurement sweep 4" in f.read()
    for (d, name), txt in pre.items():
        with open(os.path.join(d, name)) as f:
            new = f.read()
        assert new.startswith(txt), (d, name)
        assert len(new.splitlines()) == 1 + (8 if name.startswith("obs")
                                             else 4) * 2
    _, bins = tpost.SpectraBinStore.load_bins(
        os.path.join(root, "T_0.5", "spectra_bins.npz"))
    assert sorted(bins) == [2, 4, 6, 8]


def test_exact_mode_scan_and_beta_scan(tmp_path):
    """The untracked path (the CLI's default ``eigh_mode``) and a β scan
    with one replica and the anneal, through the same entry point."""
    out = tscan.run_scan_vectorized(
        tiny(tconfig.RunConfig, str(tmp_path / "ex"), eigh_mode="exact",
             n_therm=2, n_measure=2), [0.5, 2.0], replicas=1, device="cpu")
    assert out["ph_guard"]["solves"] == 1            # the init, guarded
    h, rows = _csv(os.path.join(out["dirs"][0], "observables.csv"))
    assert h == OBS_HEADER and len(rows) == 2          # one replica
    out = tscan.run_scan_vectorized(
        tiny(tconfig.RunConfig, str(tmp_path / "b"), anneal_stages=2,
             anneal_sweeps=1, n_therm=7, Nt_escalate=True),
        [0.5, 300.0], scan_param="beta", replicas=1, device="cpu")
    with open(os.path.join(str(tmp_path / "b"), "scan.log")) as f:
        assert "Anneal stage 2/2" in f.read()
    with open(os.path.join(str(tmp_path / "b"), "therm_health.json")) as f:
        assert set(json.load(f)) == {"beta_0.5", "beta_300"}


def test_batch_scan_T_main_on_cpu(tmp_path, capsys):
    root = str(tmp_path / "cli")
    out = batch_scan_T.main([
        "--device", "cpu", "--Lx", "4", "--Ly", "4", "--n_T", "2",
        "--T_min", "0.5", "--T_max", "2", "--replicas", "1",
        "--n_therm", "2", "--n_measure", "2", "--Nt_therm_init", "3",
        "--Nt_measure", "3", "--anneal_stages", "0", "--bin_size", "1",
        "--meas_probe_sweeps", "0", "--eta", "0.25", "--domega", "0.25",
        "--omega_max", "1.0", "--dtype", "float64", "--verbose", "false",
        "--out_dir", root])
    assert len(out["dirs"]) == 2
    assert os.path.exists(os.path.join(root, "summary_all.csv"))
    assert "summary:" in capsys.readouterr().out
    # --mode serial: one run_simulation per point, here on the complex path
    serial = batch_scan_T.main([
        "--mode", "serial", "--device", "cpu", "--path", "complex",
        "--Lx", "4", "--Ly", "4", "--n_T", "2", "--T_min", "0.5",
        "--T_max", "2", "--n_therm", "2", "--n_measure", "2",
        "--Nt_therm_init", "3", "--Nt_measure", "3", "--bin_size", "1",
        "--eta", "0.25", "--domega", "0.25", "--omega_max", "1.0",
        "--dtype", "float64", "--verbose", "false", "--no-summarize",
        "--out_dir", str(tmp_path / "serial")])
    assert [os.path.basename(r["out_dir"]) for r in serial] == ["T_0.5",
                                                                 "T_2"]
    for r in serial:
        h, rows = _csv(os.path.join(r["out_dir"], "observables.csv"))
        assert h == OBS_HEADER and len(rows) == 2


@pytest.mark.parametrize("kind", ["host_readout", "complex"])
def test_vectorized_scan_on_the_new_paths(tmp_path, kind):
    """The vectorized scan with the host float64 readout (thermalization in
    Nt buckets hands chain subsets to the readout's cache) and on the
    complex path: the JAX layout, finite outputs, and a resume."""
    extra = (dict(eigh_mode="tracked", metropolis_readout="host",
                  exact_solver="qdwh", Nt_escalate=True, n_therm=7,
                  dtype="float32")
             if kind == "host_readout" else dict(path="complex"))
    root = str(tmp_path / kind)
    cfg = tiny(tconfig.RunConfig, root, n_measure=2, **extra)
    out = tscan.run_scan_vectorized(cfg, [1e-3, 0.5], replicas=2,
                                    device="cpu")
    assert out["stage_sweeps"]["therm"] == cfg.n_therm
    for d in out["dirs"]:
        for name in ("observables.csv", "transport.csv"):
            h, rows = _csv(os.path.join(d, name))
            assert len(rows) == 2 * 2 if name.startswith("obs") else 2
            assert all(np.isfinite(float(x)) for r in rows for x in r[3:])
            dH = [float(r[3]) for r in rows] if name.startswith("obs") else []
            assert all(np.isfinite(v) for v in dH)
    out2 = tscan.run_scan_vectorized(
        dataclasses.replace(cfg, n_measure=4, resume=True), [1e-3, 0.5],
        replicas=2, device="cpu")
    assert out2["stage_sweeps"]["measure"] == 2
    h, rows = _csv(os.path.join(out2["dirs"][0], "observables.csv"))
    assert [int(r[0]) for r in rows] == [1, 1, 2, 2, 3, 3, 4, 4]
