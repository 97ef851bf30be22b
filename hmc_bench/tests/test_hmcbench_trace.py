"""The trace reduction on a synthetic ``torch.profiler`` trace."""

import gzip
import json

import pytest

from hmc_bench import trace as tr


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def synthetic():
    """Two periods over [100, 300] µs; device work outside them ignored."""
    return [
        ev(tr.PERIOD, "user_annotation", 100, 100),
        ev(tr.PERIOD, "user_annotation", 200, 100),
        ev("aten::bmm", "cpu_op", 100, 40),
        ev("cudaStreamSynchronize", "cuda_runtime", 250, 30),
        ev("void chain_sum_kernel<float>", "kernel", 110, 10, 7),
        ev("void chain_matvec_kernel<float>", "kernel", 130, 10, 7),
        ev("void (anonymous namespace)::sigma_cap_kernel<float, 4, 0, 1>",
           "kernel", 150, 20, 7),
        ev("rotation_s_kernel", "kernel", 165, 10, 7),      # overlaps
        ev("nvjet_tst_128x128", "kernel", 200, 40, 7),
        ev("Memcpy DtoH", "gpu_memcpy", 240, 5, 7),
        ev("lorentz_partial_kernel", "kernel", 290, 20, 7),  # cut at 300
        ev("before_the_window", "kernel", 10, 20, 7),
    ]


def test_families_put_k3_k4_k5_apart():
    assert tr.family("void chain_sum_kernel<float>") == "K3 chain_sum"
    assert tr.family("chain_sum_long_kernel") == "K3 chain_sum"
    assert tr.family("void chain_matvec_kernel<double>") == "K4 chain_matvec"
    assert tr.family("sigma_cap_kernel<float, 4, 0, 1>") == "K5 sigma_cap"
    assert tr.family("rotation_s_kernel") == "K1 rotation_s"
    assert tr.family("lorentz_finalize_kernel") == "K2 lorentzian"
    assert tr.family("void reduce_kernel<512, 1>") == "reduction"
    assert tr.family("sm80_xmma_gemm_f32f32") == "matmul"
    assert tr.family("something_else") == "other"


def test_union_of_overlapping_spans():
    assert tr.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert tr.union_us([]) == 0


def test_reduce_window_busy_and_breakdown(tmp_path):
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": synthetic()}, f)
    r = tr.reduce_file(str(path))
    assert r.window_s == pytest.approx(200e-6)
    # 110-120, 130-140, 150-175, 200-245, 290-300
    assert r.busy_s == pytest.approx(100e-6)
    assert r.kernels == 6
    assert r.families["K3 chain_sum"] == pytest.approx(10e-6)
    assert r.families["K4 chain_matvec"] == pytest.approx(10e-6)
    assert r.families["K5 sigma_cap"] == pytest.approx(20e-6)
    assert r.families["K2 lorentzian"] == pytest.approx(10e-6)
    assert r.families["other"] == pytest.approx(5e-6)      # "Memcpy"
    assert r.by_name["rotation_s_kernel"] == [1, pytest.approx(10e-6)]
    assert r.device_ops[0][0] == "nvjet_tst_128x128"
    assert len(r.device_ops) <= tr.TOP and len(r.idle_gaps) <= tr.TOP
    idle = dict(r.idle_gaps)
    # 100-110 and 120-130 lie under aten::bmm, 245-290 under the sync,
    # 140-150 and 175-200 under no host event
    assert idle["aten::bmm"] == pytest.approx(20e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(45e-6)
    assert idle["host between ops"] == pytest.approx(35e-6)
    assert sum(idle.values()) == pytest.approx(r.window_s - r.busy_s)


def test_no_period_or_no_device_work_reduces_to_none():
    events = synthetic()
    assert tr.reduce_events([e for e in events
                             if e["name"] != tr.PERIOD]) is None
    assert tr.reduce_events([e for e in events
                             if e["cat"] not in tr.DEVICE_CATS]) is None
