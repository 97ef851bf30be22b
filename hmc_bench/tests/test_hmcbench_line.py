"""The last line's schema, and the check's verdict on readings."""

import json
import math

import pytest
import torch

from hmc_bench import check, harness
from hmc_bench import trace as tr
from hmc_bench.run import result_line


def fake_run(traced=None, periods=()):
    return harness.Run(setup_s=31.5, window_s=40.0, attempted=1280,
                       accepted=1216, failed=1, peak_bytes=13 * 2**30,
                       periods=list(periods), init={}, therm=None,
                       traced=traced, counters={})


def reduced():
    return tr.Reduced(
        window_s=20.0, busy_s=19.4, kernels=64000,
        by_name={"rotation_s_kernel": [450, 0.27],
                 "void (anonymous namespace)::sigma_cap_kernel<float>":
                 [450, 0.40]},
        families={"matmul": 13.0, "eigh": 0.8, "K1 rotation_s": 0.27,
                  "K5 sigma_cap": 0.40},
        device_ops=[["nvjet", 5.0]], idle_gaps=[["aten::bmm", 0.3]])


def period(traced=True, K=10, B=64):
    z = torch.zeros((K, B))
    return harness.Period(None, None, None, z.bool(), z, None, None, 20.0,
                          traced)


def test_end_to_end_line():
    cell = harness.load_cell("dwave16_b8.fast")
    ok, table = check.judge({"dH_gap": 0.5, "flips": 0},
                            {"dH_gap": 2.0, "flips": 0})
    line = result_line(cell, fake_run(), False, ok, table,
                       "NVIDIA H100 80GB HBM3", "NVIDIA H100, 700.00 W")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True and line["failed"] == 1
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["metrics"]["traj_per_s"] == {"value": 32.0, "unit": "traj/s"}
    assert line["metrics"]["acceptance"]["value"] == 0.95
    assert line["metrics"]["peak_mem_gib"]["value"] == 13.0
    d = line["device"]
    assert d["platform"] == "gpu" and d["count"] == 1
    assert d["memory_peak_bytes"] == 13 * 2**30 and "power_limit" in d
    assert line["check"] == {"dH_gap": {"value": 0.5, "limit": 2.0},
                             "flips": {"value": 0, "limit": 0}}
    json.dumps(line)


def test_traced_line_carries_per_layer_metrics_and_breakdown():
    cell = harness.load_cell("dwave16_b8.fast")
    run = fake_run(reduced(), [period(True), period(False)])
    line = result_line(cell, run, True, True, {}, "H100", None)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    m = line["metrics"]
    assert m["device_idle_pct"]["value"] == pytest.approx(3.0)
    assert m["launches_per_traj"]["value"] == pytest.approx(100.0)
    assert m["matmul_ms_per_traj"]["value"] == pytest.approx(20.3125)
    assert 0 < m["k1_roofline_pct"]["value"] < 100
    assert 0 < m["k5_roofline_pct"]["value"] < 100
    assert 0 < m["sweep_mfu_pct"]["value"] < 100
    assert set(m) == {x["name"] for x in cell.per_layer}
    assert line["device"]["busy_s"] == 19.4
    assert line["device"]["window_s"] == 20.0
    assert line["breakdown"] == {"device_ops": [["nvjet", 5.0]],
                                 "idle_gaps": [["aten::bmm", 0.3]]}


@pytest.mark.parametrize("values,ok", [
    ({"a": 0.1, "b": 0}, True),
    ({"a": 0.3, "b": 0}, False),
    ({"a": 0.1, "b": 1}, False),
    ({"a": math.nan, "b": 0}, False),
    ({"b": 0}, False),
])
def test_judge(values, ok):
    assert check.judge(values, {"a": 0.2, "b": 0})[0] is ok
