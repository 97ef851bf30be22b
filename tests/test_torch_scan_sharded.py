"""The vectorized scan sharded over ranks (``drivers/scan.py`` under a gloo
process group, ``parallel/mesh.py``) against the one-process run.

A 4×4 float64 tracked scan, 3 points × 2 replicas = 6 chains padded to 8
over 4 ranks: every file must hold the one-process run's rows (accept
columns equal, values within 1e-10 relative), a checkpoint and resume under
4 ranks keeps the earlier rows, the PH guard falls back on every rank when
one rank's chain is gapless, and Nt buckets that leave a rank without a
chain neither deadlock nor change a row, on the tracked path, with the host
float64 readout and on the complex path.  ``batch_scan_beta`` writes the
JAX β scan's files, under 4 ranks as in one process.

Run as a script, this file is the ranks' program:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/test_torch_scan_sharded.py {scan|rest} ROOT

Each launch runs under its own time limit, so a deadlock fails the test.
"""

import dataclasses
import glob
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dwavehmc_tpu_torch.drivers import batch_scan_beta  # noqa: E402
from dwavehmc_tpu_torch.drivers import postprocess as tpost  # noqa: E402
from dwavehmc_tpu_torch.drivers import scan as tscan  # noqa: E402
from dwavehmc_tpu_torch.utils.config import RunConfig  # noqa: E402

TS = [0.5, 1.0, 0.005]
NPROC = 4
LAUNCH_SECONDS = 240
#: the forced Nt split: point 0 alone, points 1 and 2 together, so that
#: rank 0 holds no chain of the second bucket and ranks 1–3 none of the
#: first
SPLIT = {5: [0], 8: [1, 2]}
#: the other compute paths, each under the forced split: with the host
#: readout a stand-in's batch passes through the rank's potential cache
#: between the buckets
PATHS = {"host": dict(metropolis_readout="host"),
         "complex": dict(path="complex")}
BETA_ARGS = ["--device", "cpu", "--Lx", "4", "--Ly", "4", "--n_beta", "2",
             "--beta_min", "0.5", "--beta_max", "300", "--n_therm", "2",
             "--n_measure", "2", "--Nt_therm_init", "3", "--Nt_measure", "3",
             "--anneal_stages", "1", "--anneal_sweeps", "1",
             "--meas_probe_sweeps", "0", "--bin_size", "1", "--eta", "0.25",
             "--domega", "0.25", "--omega_max", "1.0", "--dtype", "float64",
             "--checkpoint_freq", "0", "--verbose", "false"]


def tiny(out_dir, **kw):
    base = dict(
        Lx=4, Ly=4, W=0.5, n_imp=0.25, J=1.0,
        eta=0.25, domega=0.25, omega_max=1.0,
        n_therm=5, n_measure=4, Nt_therm_init=5, Nt_measure=4,
        measure_transport_freq=2, bin_size=1, meas_probe_sweeps=0,
        n_chains=2, seed=3, dtype="float64", path="real",
        eigh_mode="tracked", exact_solver="ph",
        out_dir=out_dir, verbose=False, checkpoint_freq=2)
    base.update(kw)
    return RunConfig(**base)


def bucket_cfg(out_dir, **kw):
    return tiny(out_dir, n_therm=7, Nt_escalate=True, **kw)


def split_buckets(acc_point, Nt0):
    return SPLIT


# --- the ranks' program ---------------------------------------------------------

def _gapless_batch(gapless: bool):
    """(M, lattice) of two 4×4 chains with disorder and a random Δ; with
    ``gapless`` chain 0 is the clean lattice at t′ = μ = Δ = 0, whose band
    touches zero."""
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, static_embedding)
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.sampler.hmc_real import draw_init_state

    lat = LatticeSpec(4, 4)
    tp, mu = [-0.35, -0.35], [-1.08, -1.08]
    if gapless:
        tp[0] = mu[0] = 0.0
    p = make_params(tp=tp, mu=mu, W=0.5, n_imp=0.25, dtype=torch.float64,
                    device="cpu")
    g = torch.Generator().manual_seed(11)
    d, re, im = draw_init_state(lat, p, 2, generator=g, dtype=torch.float64,
                                device="cpu")
    if gapless:
        for x in (d, re, im):
            x[0] = 0.0
    return assemble_embedding(lat, static_embedding(lat, p.t, p.tp, p.mu, d),
                              re, im)


def _rank_rest(root: str, rank: int) -> dict:
    from dwavehmc_tpu_torch.drivers import batch_scan_T
    from dwavehmc_tpu_torch.models.bdg_real import diagonalize_embedding
    from dwavehmc_tpu_torch.ops import ph_eigh

    out = {}
    for name, gapless, vote in (("healthy", False, None),
                                ("gapless_on_3", rank == 3, None),
                                ("gapless_on_3_abstains", rank == 3,
                                 [False, True])):
        M = _gapless_batch(gapless)
        ph_eigh.reset_guard()
        ev, X, Y, fb = ph_eigh.diagonalize_embedding_ph_guarded(M, vote=vote)
        ev0, X0, Y0 = diagonalize_embedding(M)
        out[name] = {"fallback": fb, "guard": dict(ph_eigh.GUARD),
                     "equals_full_eigh": all(bool(torch.equal(a, b)) for a, b
                                             in ((ev, ev0), (X, X0),
                                                 (Y, Y0)))}
    tscan.nt_buckets = split_buckets
    res = tscan.run_scan_vectorized(bucket_cfg(os.path.join(root, "split")),
                                    TS, replicas=2, device="cpu")
    out["split"] = {"ranks": res["ranks"], "ph_guard": res["ph_guard"]}
    for kind, kw in PATHS.items():
        tscan.run_scan_vectorized(bucket_cfg(os.path.join(root, kind), **kw),
                                  TS, replicas=2, device="cpu")
    batch_scan_beta.main(BETA_ARGS + ["--out_dir", os.path.join(root, "beta")])
    try:
        batch_scan_T.main(["--mode", "serial", "--device", "cpu"])
        out["serial_error"] = None
    except ValueError as e:
        out["serial_error"] = str(e)
    return out


def _rank_scan(root: str, rank: int) -> dict:
    from dwavehmc_tpu_torch.parallel.mesh import barrier

    res = tscan.run_scan_vectorized(tiny(os.path.join(root, "sharded")), TS,
                                    replicas=2, device="cpu")
    if rank == 0:
        shutil.copytree(os.path.join(root, "sharded"),
                        os.path.join(root, "resumed"))
    barrier()
    tscan.run_scan_vectorized(tiny(os.path.join(root, "resumed"), n_measure=8,
                                   resume=True), TS, replicas=2, device="cpu")
    return {"ranks": res["ranks"], "ph_guard": res["ph_guard"],
            "world_size": res["world_size"]}


def _rank_main(mode: str, root: str) -> None:
    from dwavehmc_tpu_torch.parallel.mesh import (
        maybe_setup_distributed, teardown_distributed, world)

    torch.set_num_threads(1)
    assert maybe_setup_distributed()
    rank, _ = world()
    try:
        out = (_rank_scan if mode == "scan" else _rank_rest)(root, rank)
        with open(os.path.join(root, f"{mode}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        teardown_distributed()


# --- the tests ----------------------------------------------------------------

def launch(mode: str, root: str) -> None:
    """This file as the program of NPROC gloo ranks, under a time limit
    after which the whole process group is killed."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", SKIP_QUICK_TESTS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(NPROC), os.path.abspath(__file__), mode,
           root]
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=LAUNCH_SECONDS)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"{mode}: {NPROC} ranks did not finish in "
                    f"{LAUNCH_SECONDS} s (deadlock?)\n{log[-4000:]}")
    assert proc.returncode == 0, log[-4000:]


def rank_results(root: str, mode: str) -> list:
    out = []
    for r in range(NPROC):
        with open(os.path.join(root, f"{mode}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs, then the two launches of 4 ranks."""
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("sharded"))
    one = tscan.run_scan_vectorized(tiny(os.path.join(root, "one")), TS,
                                    replicas=2, device="cpu")
    shutil.copytree(os.path.join(root, "one"), os.path.join(root,
                                                             "one_resumed"))
    tscan.run_scan_vectorized(tiny(os.path.join(root, "one_resumed"),
                                   n_measure=8, resume=True), TS, replicas=2,
                              device="cpu")
    nt_buckets = tscan.nt_buckets
    tscan.nt_buckets = split_buckets
    try:
        split = tscan.run_scan_vectorized(
            bucket_cfg(os.path.join(root, "one_split")), TS, replicas=2,
            device="cpu")
        for kind, kw in PATHS.items():
            tscan.run_scan_vectorized(
                bucket_cfg(os.path.join(root, f"one_{kind}"), **kw), TS,
                replicas=2, device="cpu")
    finally:
        tscan.nt_buckets = nt_buckets
    batch_scan_beta.main(BETA_ARGS + ["--out_dir",
                                      os.path.join(root, "one_beta")])
    launch("scan", root)
    launch("rest", root)
    return root, one, split


def _csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], np.array([[float(x) for x in ln.split(",")]
                               for ln in lines[1:]])


def assert_same_run(a: str, b: str) -> None:
    """Run directories ``a`` (one process) and ``b`` (4 ranks): the same
    files; CSV accept columns equal and every value within 1e-10
    relative; the same health and bins; the same checkpoint.  (A summary
    is made from the CSVs compared.)"""
    files = sorted(os.path.relpath(p, a) for p in glob.glob(
        os.path.join(a, "**"), recursive=True))
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(
        os.path.join(b, "**"), recursive=True))
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith("summary_all.csv"):
            continue
        if rel.endswith(".csv"):
            ha, va = _csv(pa)
            hb, vb = _csv(pb)
            assert ha == hb and va.shape == vb.shape, rel
            acc = ha.split(",").index("Accepted") if "Accepted" in ha else 0
            np.testing.assert_array_equal(va[:, :acc + 1], vb[:, :acc + 1])
            np.testing.assert_allclose(vb, va, rtol=1e-10, atol=0, err_msg=rel)
        elif rel.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    np.testing.assert_allclose(zb[k], za[k], rtol=1e-10,
                                               atol=1e-14, err_msg=k)
        elif rel == "therm_health.json":
            with open(pa) as fa, open(pb) as fb:
                ja, jb = json.load(fa), json.load(fb)
            assert ja.keys() == jb.keys()
            for k in ja:
                for name, x in ja[k].items():
                    if isinstance(x, dict):
                        for m, v in x.items():
                            assert jb[k][name][m] == pytest.approx(
                                v, rel=1e-10), (k, name, m)
                    else:
                        assert jb[k][name] == pytest.approx(x, rel=1e-10)


def _log(root: str) -> str:
    with open(os.path.join(root, "scan.log")) as f:
        return f.read()


def test_sharded_scan_equals_one_process(runs):
    root, one, _ = runs
    assert_same_run(os.path.join(root, "one"), os.path.join(root, "sharded"))
    log = _log(os.path.join(root, "sharded"))
    assert ("Padding ensemble with 2 throwaway chain(s) to reach a multiple "
            "of 4 devices (6 -> 8).") in log
    assert "4 rank(s) on the CPU" in log

    def init_line(text):
        return next(ln.split("] ", 1)[1] for ln in text.splitlines()
                    if "Initial ensemble" in ln)

    assert init_line(log) == init_line(_log(os.path.join(root, "one")))
    ranks = rank_results(root, "scan")
    assert all(r["world_size"] == NPROC for r in ranks)
    assert ranks[0]["ph_guard"] == one["ph_guard"]
    per_rank = ranks[0]["ranks"]
    assert [r["rank"] for r in per_rank] == list(range(NPROC))
    assert len({json.dumps(r["ph_guard"]) for r in per_rank}) == 1


def test_sharded_resume_keeps_earlier_rows(runs):
    root, _, _ = runs
    for d in sorted(glob.glob(os.path.join(root, "sharded", "T_*"))):
        rd = os.path.join(root, "resumed", os.path.basename(d))
        for name in ("observables.csv", "transport.csv"):
            with open(os.path.join(d, name)) as f:
                before = f.read()
            with open(os.path.join(rd, name)) as f:
                after = f.read()
            assert after.startswith(before), (rd, name)
            assert len(after.splitlines()) == 1 + (8 if name.startswith("obs")
                                                   else 4) * 2
    assert "Resumed scan at measurement sweep 4" in _log(
        os.path.join(root, "resumed"))
    assert_same_run(os.path.join(root, "one_resumed"),
                    os.path.join(root, "resumed"))


@pytest.mark.parametrize("case,fallback", [("healthy", False),
                                          ("gapless_on_3", True),
                                          ("gapless_on_3_abstains", False)])
def test_guard_falls_back_on_every_rank(runs, case, fallback):
    root, _, _ = runs
    got = [r[case] for r in rank_results(root, "rest")]
    assert [g["fallback"] for g in got] == [fallback] * NPROC
    assert all(g["guard"]["solves"] == 1 and
               g["guard"]["fallbacks"] == int(fallback) for g in got)
    if fallback:
        assert all(g["equals_full_eigh"] for g in got)
        assert [sum(g["guard"][k] for k in ("resid_failed", "ratio_failed",
                                            "nonfinite")) > 0
                for g in got] == [False, False, False, True]


def test_rank_without_a_bucket_chain_completes(runs):
    root, _, split = runs
    log = _log(os.path.join(root, "split"))
    assert "Therm buckets (Nt -> #points): {5: 1, 8: 2}" in log
    assert_same_run(os.path.join(root, "one_split"),
                    os.path.join(root, "split"))
    ranks = rank_results(root, "rest")
    assert ranks[0]["split"]["ph_guard"] == split["ph_guard"]
    launches = [r["launches"] for r in ranks[0]["split"]["ranks"]]
    assert all(x == launches[0] for x in launches)


@pytest.mark.parametrize("kind", sorted(PATHS))
def test_other_paths_sharded_equal_one_process(runs, kind):
    """The host readout and the complex path under 4 ranks and the forced
    Nt split write the one-process run's files."""
    root, _, _ = runs
    assert "Therm buckets (Nt -> #points): {5: 1, 8: 2}" in _log(
        os.path.join(root, kind))
    assert_same_run(os.path.join(root, f"one_{kind}"),
                    os.path.join(root, kind))


def test_batch_scan_beta_writes_the_jax_beta_scan(runs, tmp_path):
    """The β entry point under 4 ranks as in one process, and the JAX
    package's β scan of the same config writes the same files, which
    ``summarize_scan(root, "beta_", "beta")`` reads."""
    from dwavehmc_tpu.drivers import postprocess as jpost
    from dwavehmc_tpu.drivers import scan as jscan
    from dwavehmc_tpu.utils import config as jconfig

    root, _, _ = runs
    one, four = os.path.join(root, "one_beta"), os.path.join(root, "beta")
    assert_same_run(one, four)
    ns = batch_scan_beta.parser().parse_args(BETA_ARGS)
    cfg = jconfig.RunConfig(**{
        f.name: getattr(ns, f.name) for f in dataclasses.fields(
            jconfig.RunConfig)} | {"out_dir": str(tmp_path / "jax")})
    betas = tscan.default_beta_grid(ns.n_beta, ns.beta_min, ns.beta_max)
    jscan.run_scan_vectorized(cfg, betas, scan_param="beta")

    def tree(r):
        return sorted(os.path.relpath(p, r) for p in glob.glob(
            os.path.join(r, "**"), recursive=True)
            if not p.endswith("summary_all.csv"))

    assert tree(four) == tree(cfg.out_dir)
    for d in sorted(glob.glob(os.path.join(cfg.out_dir, "beta_*"))):
        for name in ("observables.csv", "transport.csv"):
            hj, vj = _csv(os.path.join(d, name))
            ht, vt = _csv(os.path.join(four, os.path.basename(d), name))
            assert ht == hj and vt.shape == vj.shape
    with open(jpost.summarize_scan(four, "beta_", "beta")) as f:
        jsum = f.read()
    with open(tpost.summarize_scan(four, "beta_", "beta")) as f:
        assert f.read() == jsum
    assert len(jsum.splitlines()) == 1 + ns.n_beta


def test_serial_mode_refuses_several_ranks(runs):
    root, _, _ = runs
    errs = [r["serial_error"] for r in rank_results(root, "rest")]
    assert all(e is not None and "--mode vectorized" in e for e in errs)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
