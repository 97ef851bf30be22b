"""The port's profiler and model-FLOP tools against the JAX scripts, on the
CPU:

* ``drivers/analyze_trace``: one hand-made chrome trace (nested complete
  events on a TPU "XLA Ops" track, the same events as CUDA kernels on a
  stream track, and a CPU track, with their metadata) through
  ``scripts/analyze_trace`` and the port: per-track busy, span, duty and
  top ops equal, and the device self time by category equal (the JAX
  script's by ``hlo_category`` on the TPU track, the port's by kernel
  family on the stream track); the port reports the stream track as the
  device's busy time;
* ``utils/flops.tracked_model_flops`` equal to ``bench.tracked_model_flops``
  on a grid of (L, Nt, K, scheme, ns_steps);
* ``drivers/ab_rotation``: ``VARIANTS`` and ``model_tflops`` equal to the
  JAX script's;
* ``drivers/profile_production`` at 4×4, 2 chains, 1 sweep: the JSON's
  keys are those of the committed ``examples/profile_production.json``, and
  its ``torch.profiler`` trace parses (also through the CLI).
"""

import importlib.util
import itertools
import json
import os

import torch

from dwavehmc_tpu_torch.drivers import ab_rotation as abr
from dwavehmc_tpu_torch.drivers import analyze_trace as at
from dwavehmc_tpu_torch.drivers import profile_production as pp
from dwavehmc_tpu_torch.utils import flops

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_script(name):
    return load(os.path.join(REPO, "scripts", f"{name}.py"), f"jax_{name}")


def meta(kind, pid, tid, name):
    return {"ph": "M", "name": kind, "pid": pid, "tid": tid,
            "args": {"name": name}}


#: (ts, dur, TPU op, its hlo_category, CUDA kernel name of that family)
NESTED = [(0.0, 1000.0, "while.1", "other", "while_body_loop"),
          (0.0, 400.0, "fusion.3", "matmul", "sm90_xmma_gemm_f32"),
          (500.0, 200.0, "fusion.4", "elementwise",
           "vectorized_elementwise_kernel"),
          (550.0, 50.0, "copy.1", "copy", "copy_kernel"),
          (1200.0, 300.0, "custom-call.9", "eigh", "syevj_batch_kernel"),
          (1600.0, 100.0, "fusion.5", "matmul", "gemv2T_kernel")]


def hand_made_trace(path):
    ev = [meta("process_name", 1, 0, "/device:TPU:0"),
          meta("thread_name", 1, 2, "XLA Ops"),
          meta("process_name", 0, 0, "GPU 0"),
          meta("thread_name", 0, 7, "stream 7"),
          meta("process_name", 100, 0, "python"),
          meta("thread_name", 100, 100, "thread 100 (python)"),
          {"ph": "i", "name": "marker", "pid": 100, "tid": 100, "ts": 3.0}]
    for ts, dur, op, cat, kernel in NESTED:
        ev.append({"ph": "X", "name": op, "pid": 1, "tid": 2, "ts": ts,
                   "dur": dur, "args": {"hlo_category": cat}})
        ev.append({"ph": "X", "cat": "kernel", "name": kernel, "pid": 0,
                   "tid": 7, "ts": ts + 30.0, "dur": dur,
                   "args": {"stream": 7}})
    for ts, dur, name in ((-20.0, 1900.0, "segment"), (0.0, 900.0, "sweep"),
                          (10.0, 300.0, "aten::matmul"),
                          (10.0, 250.0, "aten::mm"),
                          (950.0, 700.0, "sweep")):
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "pid": 100,
                   "tid": 100, "ts": ts, "dur": dur})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_analyze_matches_the_jax_script_on_a_hand_made_trace(tmp_path):
    path = str(tmp_path / "hand.trace.json")
    hand_made_trace(path)
    ref = jax_script("analyze_trace")
    want, got = ref.analyze(path, 12), at.analyze(path, 12)
    assert got["file"] == want["file"]
    assert list(got["tracks"]) == list(want["tracks"])
    for key, tr in want["tracks"].items():
        g = got["tracks"][key]
        for k in ("busy_ms", "span_ms", "duty_pct"):
            assert abs(g[k] - tr[k]) <= 1e-12, (key, k)
        assert list(g["top_ops_ms"]) == list(tr["top_ops_ms"])
        for op, ms in tr["top_ops_ms"].items():
            assert abs(g["top_ops_ms"][op] - ms) <= 1e-12

    cw, cg = ref.category_self_time(path), at.category_self_time(path)
    assert abs(cg["total_s"] - cw["total_s"]) <= 1e-12
    assert set(cg["by_category_pct"]) == set(cw["by_category_pct"])
    for c, pct in cw["by_category_pct"].items():
        assert abs(cg["by_category_pct"][c] - pct) <= 1e-12, c

    dev = got["device"]
    assert dev["tracks"] == ["GPU 0/stream 7"]
    assert dev["events"] == len(NESTED)
    # the union of [30, 1030], [1230, 1530] and [1630, 1730] over the
    # window [-20, 1880] of every complete event
    assert abs(dev["busy_ms"] - 1.4) <= 1e-12
    assert abs(dev["window_ms"] - 1.9) <= 1e-12
    assert dev["family_ms"]["matmul"] == 0.5


def test_self_times_nest_a_child_that_shares_its_parents_start():
    assert at.self_times([(0.0, 10.0), (0.0, 4.0), (5.0, 2.0),
                          (20.0, 1.0)]) == [4.0, 4.0, 2.0, 1.0]


def test_tracked_model_flops_equal_the_benchmarks(monkeypatch, tmp_path):
    # bench.py points JAX's compilation cache at its checkout unless set
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    bench = load(os.path.join(REPO, "bench.py"), "jax_bench")
    for L, Nt, K, scheme, ns in itertools.product(
            (4, 16, 24, 32), (4, 6, 20), (1, 5, 10), ("ns", "exp2"),
            (0, 1, 2)):
        args = (L, Nt, 8, 20, 6, K, 12, 4, ns, scheme)
        assert (flops.tracked_model_flops(*args)
                == bench.tracked_model_flops(*args)), args


def test_ab_rotation_variants_and_flops_equal_the_jax_scripts():
    ref = jax_script("ab_rotation")
    assert abr.VARIANTS == ref.VARIANTS
    for v in ref.VARIANTS:
        _, scheme, ns, _, _, ov = v
        args = (24, 6, 64, 10, ov.get("tracked_iters", 6), 10,
                ov.get("refine_iters", 12), ov.get("polish_iters", 4), ns,
                scheme)
        assert abr.model_tflops(*args) == ref.model_tflops(*args)
    assert [v[0] for v in abr.select("exp2_ph,baseline")] == [
        "baseline", "exp2_ph"]


PROF_ENV = dict(PROF_L="4", PROF_BATCH="2", PROF_SWEEPS="1", PROF_THERM="1")


def test_profile_production_keys_and_trace(monkeypatch, tmp_path, capsys):
    for k, v in PROF_ENV.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "profile_production.json"
    got = pp.main(["--device", "cpu", "--out", str(out), "--trace_dir",
                   str(tmp_path / "trace")])
    with open(os.path.join(REPO, "examples", "profile_production.json")) as f:
        want = json.load(f)
    assert list(got) == list(want)
    assert json.loads(out.read_text()) == got
    assert set(want["config"]) < set(got["config"])
    assert got["config"]["nominal_peak"]["tflops"] == 989.0
    assert got["trace_error"] is None and got["device"] == "cpu"
    (analysis,) = got["track_analyses"]
    assert analysis["tracks"] and analysis["device"]["events"] == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["trace_ok"] is True and summary["n_track_analyses"] == 1

    (cli,) = at.main([str(tmp_path / "trace"), "--top", "3", "--categories"])
    assert list(cli["tracks"]) == list(analysis["tracks"])
    assert cli["device_self_time"]["total_s"] == 0
