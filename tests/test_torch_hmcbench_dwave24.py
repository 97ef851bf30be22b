"""The production cell ``dwave24_b64.fast``'s files, on the CPU: 64
disorder realizations of the 24×24 lattice under the fast mix.

* the cell loads by name and its ``RunConfig`` validates, at the width
  and chain count it exists for;
* its work B·(2N)² lies above the CUDA graph's gate
  (``parallel/cheap_graph.GRAPH_MAX_WORK``), so its cheap sweeps run
  eagerly, the side of the gate no other cell runs; a change of the gate
  that moves it must change this test;
* every number its limits compare, and every one they print, is one that
  ``hmc_bench.check.readings`` produces (on the cell's tiny CPU version:
  6×6, 4 chains);
* the reader of ``anchor_redo_pct`` on a hand-made context.

Imports only torch, the port and the benchmark's harness.
"""

import types

import pytest
import torch

from dwavehmc_tpu_torch.parallel import cheap_graph
from hmc_bench import check, harness

torch.set_num_threads(2)

CELL = "dwave24_b64.fast"
BENCH = harness.load_benchmark()


def test_the_cell_loads_at_the_production_width():
    c = harness.load_cell(CELL)
    cfg = harness.run_config(c)
    assert (cfg.Lx, cfg.Ly, cfg.n_chains) == (24, 24, 64)
    assert (cfg.dtype, cfg.path, cfg.eigh_mode, cfg.exact_solver) == (
        "float32", "real", "tracked", "ph")
    assert (cfg.n_therm, cfg.Nt_therm_init) == (2, 20)
    assert harness.dt_factor(c) == 0.6
    assert cfg.anchor_every == 10 and cfg.Nt_measure == 6
    want = harness.load_cell("dwave16_b8.fast").config
    for k in ("t", "tp", "mu", "W", "n_imp", "beta", "J", "mass"):
        assert c.config[k] == want[k], k
    entry = {e["name"]: e for e in BENCH["configs"]}["dwave24_b64"]
    assert entry["reduced"] == c.config["reduced"] == ["n_therm"]
    assert entry["source"] == c.config["source"]
    assert len(entry["source"]) <= 200


def test_the_cell_runs_on_the_eager_side_of_the_graph_gate():
    cfg = harness.run_config(harness.load_cell(CELL))
    dim = 2 * cfg.Lx * cfg.Ly
    assert cfg.n_chains * dim**2 == 84_934_656 > cheap_graph.GRAPH_MAX_WORK
    assert not cheap_graph.graph_worthwhile(cfg.n_chains, dim)
    small = harness.run_config(harness.load_cell("dwave16_b8.fast"))
    assert cheap_graph.graph_worthwhile(small.n_chains,
                                        2 * small.Lx * small.Ly)


def _tiny(name):
    """The cell on a 6×6 lattice with 4 chains, one thermalization sweep
    and 3-sweep anchor periods, every chain and period sampled."""
    c = harness.load_cell(name)
    return c._replace(
        config=dict(c.config, Lx=6, Ly=6, n_chains=4, n_therm=1,
                    Nt_therm_init=3),
        traffic=dict(c.traffic, anchor_every=3),
        limits=dict(c.limits, sample={"chains": 4, "periods": 8}))


def test_every_limit_names_a_reading():
    c = _tiny(CELL)
    seed = 3500000012
    run = harness.run_cell(c, seed, 0.0, False, "cpu")
    values = check.readings(c, run, seed, "cpu")
    limits = harness.load_cell(CELL).limits
    assert set(limits["limits"]) <= set(values)
    assert set(limits.get("readings", {})) - {"source"} <= set(values)
    assert set(limits["sample"]) == {"chains", "periods"}
    ok, table = check.judge(values, limits["limits"])
    assert set(table) == set(limits["limits"])


def _ctx(counters, traced_traj=640, chains=64):
    return types.SimpleNamespace(
        counters=counters, traced_traj=traced_traj,
        cfg=types.SimpleNamespace(n_chains=chains))


def test_anchor_redo_pct_reads_the_guard():
    read = harness.reader("anchor_redo_pct")
    guard = {"solves": 2, "fallbacks": 1, "rescued": 0}
    assert read(_ctx({"ph_guard": dict(guard, redone=0)})) == 0.0
    assert read(_ctx({"ph_guard": dict(guard, redone=1)})) == pytest.approx(
        100.0 / 128)
    # a program without the count, no solve, or no traced trajectory
    assert read(_ctx({"ph_guard": guard})) is None
    assert read(_ctx({"ph_guard": dict(guard, solves=0, redone=0)})) is None
    assert read(_ctx({"ph_guard": dict(guard, redone=0)},
                     traced_traj=0)) is None
    assert read(_ctx({})) is None


def test_anchor_redo_pct_is_reported_in_every_cell():
    m = {e["name"]: e for e in BENCH["per_layer"]}["anchor_redo_pct"]
    assert m == {"name": "anchor_redo_pct", "unit": "%", "better": "lower",
                 "source": "program_counter",
                 "layer": "Exact anchor (ops/ph_eigh.py, models/bdg_real.py)",
                 "moves": "traj_per_s"}
    layers = {e["layer"] for e in BENCH["per_layer"]
              if e["name"] in ("eigh_ms_per_traj", "ph_fallback_pct")}
    assert layers == {m["layer"]}
    # the graph's share is read in both cells: 0 here, the eager side
    cheap = {e["name"]: e for e in BENCH["per_layer"]}["cheap_graph_pct"]
    assert cheap["workloads"] == ["dwave16_b8.fast", CELL]
