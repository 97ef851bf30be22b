"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding each cell's configuration, mix, limits and metric readers by
name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from hmc_bench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hmc_bench"]
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(
        1 <= len(w) <= 200 and not w.startswith("/") and ".." not in w
        for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180
            + 1200 <= 43200)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
    for e in BENCH["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert e["file"].startswith("hmc_bench/")
        assert (ROOT / e["file"]).is_file()
        assert len(e["reduced"]) <= 16
        cfg = json.loads((ROOT / e["file"]).read_text())
        assert cfg["reduced"] == e["reduced"] and cfg["source"] == e["source"]
    configs = {e["name"] for e in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_with_its_readers(cell):
    c = harness.load_cell(cell)
    cfg = harness.run_config(c)
    assert cfg.n_chains == c.config["n_chains"]
    assert c.limits["limits"] and set(c.limits["sample"]) == {"chains",
                                                             "periods"}
    assert c.per_layer and all(callable(harness.reader(m["name"]))
                               for m in c.per_layer)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "traj_per_s"} <= names


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A cell that a later change adds: its own configuration, mix, limits
    and reader, and an entry in the workloads; no file edited."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / sub)
    (tmp_path / "configs" / "dwave12_b4.json").write_text(json.dumps(
        dict(json.loads((harness.HERE / "configs" / "dwave16_b8.json")
                        .read_text()), name="dwave12_b4", Lx=12, Ly=12,
             n_chains=4)))
    (tmp_path / "traffic" / "slow.json").write_text(json.dumps(
        dict(json.loads((harness.HERE / "traffic" / "fast.json")
                        .read_text()), anchor_every=5)))
    (tmp_path / "limits" / "dwave12_b4.slow.json").write_text(json.dumps(
        {"sample": {"chains": 1, "periods": 1}, "limits": {"dH_gap": 1}}))
    (tmp_path / "metrics" / "periods_traced.py").write_text(
        "def read(ctx):\n    return ctx.traced_periods or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "dwave12_b4.slow",
                               "config": "dwave12_b4", "traffic": "slow",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "periods_traced", "unit": "periods",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device (H100)",
                               "moves": "traj_per_s",
                               "workloads": ["dwave12_b4.slow"]})
    c = harness.load_cell("dwave12_b4.slow", bench, here=tmp_path)
    assert harness.run_config(c).anchor_every == 5
    assert "periods_traced" in {m["name"] for m in c.per_layer}
    assert harness.reader("periods_traced", here=tmp_path)(
        type("Ctx", (), {"traced_periods": 3})()) == 3


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no_such.cell")
    c = harness.load_cell(BENCH["workloads"][0]["name"])
    with pytest.raises(KeyError):
        harness.run_config(c._replace(traffic=dict(c.traffic, bogus=1)))


def test_file_names_are_made_of_name_characters():
    for p in Path(harness.HERE).rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
