"""The port's spans and host-sync counters (``utils/profiling.span``), on
the CPU:

* ``span`` does nothing while no ``torch.profiler`` session is on (no
  range, no clock read, nothing in ``SPANS``), and under one records
  nested spans and a span an exception leaves;
* a 6×6, 2-chain, K = 3, Nt = 2 ``run_segment_tracked`` under
  ``torch.profiler``: the chrome trace's ``dwavehmc.*`` ranges equal
  ``SPANS`` in count and in summed duration (5 % or 2 ms), at the sites
  the sweep has; and the segment is bit-equal with and without a profiler;
* a number step ``dt`` given to ``tracked_leapfrog`` or
  ``run_segment_hostacc`` makes no ``leapfrog_dt`` host sync;
* the benchmark's seven readers of them, on a hand-made context;
* ``drivers/analyze_trace``: K3–K5 in ``FAMILIES`` as in the benchmark's
  frozen copy, and the device's time under each innermost range, matched
  by correlation id, on a hand-made trace.
"""

import collections
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dwavehmc_tpu_torch.drivers import analyze_trace as at
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.parallel import ensemble
from dwavehmc_tpu_torch.sampler import hmc_real
from dwavehmc_tpu_torch.utils import profiling
from hmc_bench import harness
from hmc_bench import trace as frozen

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof, tmp_path, prefix=profiling.PREFIX):
    """(count, summed µs) of each ``user_annotation`` range of the
    exported chrome trace whose name starts with ``prefix``."""
    path = str(tmp_path / "spans.trace.json")
    prof.export_chrome_trace(path)
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in at.load_events(path):
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith(prefix)):
            out[e["name"]][0] += 1
            out[e["name"]][1] += float(e["dur"])
    return dict(out)


def test_a_span_without_a_profiler_does_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched while no profiler is on")

    monkeypatch.setattr(profiling.torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter", refuse)
    for _ in range(3):
        with profiling.span("dwavehmc.x"):
            with profiling.sync_span("y"):
                pass
    assert profiling.SPANS == {}


def test_spans_nest_and_close_on_an_exception(tmp_path):
    with _cpu_profile() as prof:
        with profiling.span("dwavehmc.outer"):
            for _ in range(2):
                with profiling.span("dwavehmc.inner"):
                    torch.ones(4).sum()
            with pytest.raises(ValueError):
                with profiling.sync_span("site"):
                    raise ValueError("left by an exception")
    spans = profiling.SPANS
    assert {k: v[0] for k, v in spans.items()} == {
        "dwavehmc.outer": 1, "dwavehmc.inner": 2, "dwavehmc.sync.site": 1}
    assert spans["dwavehmc.outer"][1] >= spans["dwavehmc.inner"][1] > 0
    ranges = _ranges(prof, tmp_path)
    assert {k: v[0] for k, v in ranges.items()} == {
        k: v[0] for k, v in spans.items()}
    profiling.reset_spans()
    assert profiling.SPANS == {}


def test_the_phase_timer_opens_a_span_under_a_profiler():
    timer = profiling.PhaseTimer()
    with timer.span("io"):
        pass
    assert profiling.SPANS == {} and "io" in timer.spans
    with _cpu_profile():
        with timer.span("io"):
            pass
    assert profiling.SPANS["dwavehmc.io"][0] == 1


L, B, K, NT, SWEEPS = 6, 2, 3, 2, 3
TRACK = dict(tracked_iters=4, refine_iters=2, polish_iters=1, ns_steps=1,
             rot_scheme="exp2", rot_dtype=torch.bfloat16, exact_solver="ph")


def _segment(traced: bool):
    lat = LatticeSpec(L, L)
    p = make_params(W=1.0, n_imp=0.05, beta=10.0, J=0.8, device="cpu")
    g = torch.Generator().manual_seed(7)
    s = ensemble.init_ensemble_real(lat, p, g, B, n_imp=0.05,
                                    exact_solver="ph", device="cpu")
    prof = _cpu_profile() if traced else None
    if prof is not None:
        prof.start()
    s, seg = ensemble.run_segment_tracked(lat, p, s, SWEEPS, NT, 0.05,
                                          measure=True, anchor_every=K,
                                          generator=g, **TRACK)
    if prof is not None:
        prof.stop()
    return s, seg, prof


@pytest.fixture(scope="module")
def segments():
    profiling.reset_spans()
    plain = _segment(False)
    assert profiling.SPANS == {}
    traced = _segment(True)
    spans = {k: list(v) for k, v in profiling.SPANS.items()}
    return plain, traced, spans


def test_segment_ranges_equal_the_registry(segments, tmp_path):
    _, (_, _, prof), spans = segments
    n = {k: v[0] for k, v in spans.items()}
    cheap = SWEEPS - 1                       # K = 3: two cheap, one anchored
    assert n["dwavehmc.sweep"] == n["dwavehmc.leapfrog"] == SWEEPS
    assert n["dwavehmc.observables"] == SWEEPS
    assert n["dwavehmc.accept_cheap"] == cheap and n["dwavehmc.anchor"] == 1
    assert n["dwavehmc.forces"] == SWEEPS * (NT + 1)
    assert n["dwavehmc.tracked_eigh"] == SWEEPS * NT + 2 * cheap
    assert n["dwavehmc.sync.ph_guard"] == 1
    assert n["dwavehmc.sync.eigh_info"] >= 1
    # a number dt is filled on the device once a segment, and the forces'
    # neighbour table was copied once, by the untraced run: no copy from
    # the host waits for the stream
    assert "dwavehmc.sync.leapfrog_dt" not in n
    assert "dwavehmc.sync.forces_nn_table" not in n
    ranges = _ranges(prof, tmp_path)
    assert {k: v[0] for k, v in ranges.items()} == n
    for name, (_, secs) in spans.items():
        us = ranges[name][1]
        assert abs(us * 1e-6 - secs) <= max(0.05 * secs, 2e-3), (name, us,
                                                                 secs)


def test_segment_is_bit_equal_under_a_profiler(segments):
    (s0, seg0, _), (s1, seg1, _), _ = segments
    assert torch.equal(seg0.dH, seg1.dH)
    assert torch.equal(seg0.accepted, seg1.accepted)
    for a, b in ((s0.delta_re, s1.delta_re), (s0.delta_im, s1.delta_im),
                 (s0.evals, s1.evals)):
        assert torch.equal(a, b)


def _leapfrog_runs(runner, dt):
    """One tracked leapfrog (or one host-readout sweep) of 2 chains at 4×4
    with the step ``dt``, from the same ensemble and draws every call."""
    lat = LatticeSpec(4, 4)
    p = make_params(W=1.0, n_imp=0.05, beta=10.0, J=0.8, device="cpu")
    s = ensemble.init_ensemble_real(lat, p, torch.Generator().manual_seed(3),
                                    2, n_imp=0.05, exact_solver="ph",
                                    device="cpu")
    g = torch.Generator().manual_seed(4)
    if runner == "tracked_leapfrog":
        return tuple(hmc_real.tracked_leapfrog(lat, p, s, 2, dt, 2, 1, 1,
                                               generator=g))
    s, seg, _ = ensemble.run_segment_hostacc(lat, p, s, 1, 2, dt,
                                             measure=False, tracked_iters=2,
                                             exact_solver="ph", generator=g)
    return tuple(s) + (seg.accepted, seg.dH)


@pytest.mark.parametrize("runner", ["tracked_leapfrog",
                                    "run_segment_hostacc"])
def test_a_number_step_is_filled_on_the_device(runner):
    """A Python number ``dt`` becomes a device tensor without a copy from
    the host (``sampler/hmc_real.device_step``): no
    ``dwavehmc.sync.leapfrog_dt`` under a profiler, and the bits of the
    same step given as a device tensor."""
    with _cpu_profile():
        got = _leapfrog_runs(runner, 0.05)
    assert profiling.SPANS["dwavehmc.leapfrog"][0] == 1
    assert "dwavehmc.sync.leapfrog_dt" not in profiling.SPANS
    want = _leapfrog_runs(runner, torch.tensor(0.05))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


#: a hand-made registry: 10 traced sweeps of 8 chains (80 trajectories)
REGISTRY = {"dwavehmc.sweep": [10, 1.2], "dwavehmc.leapfrog": [10, 1.0],
            "dwavehmc.tracked_eigh": [80, 0.64],
            "dwavehmc.anchor": [1, 0.08],
            "dwavehmc.sync.ph_guard": [1, 0.002],
            "dwavehmc.sync.eigh_info": [1, 0.006],
            "dwavehmc.cheap_graph": [8, 0.02],
            "dwavehmc.accept_cheap": [1, 0.01]}
GUARD = {"solves": 4, "fallbacks": 1}
READINGS = [("leapfrog_host_ms_per_traj", 12.5),
            ("tracked_eigh_host_ms_per_traj", 8.0),
            ("anchor_host_ms_per_traj", 1.0),
            ("sync_wait_ms_per_traj", 0.1),
            ("host_syncs_per_sweep", 0.2),
            ("ph_fallback_pct", 25.0),
            ("cheap_graph_pct", 800.0 / 9)]


def _ctx(traj=80, counters=None):
    return types.SimpleNamespace(
        traced_traj=traj, cfg=types.SimpleNamespace(n_chains=8),
        counters={"ph_guard": dict(GUARD)} if counters is None else counters)


@pytest.mark.parametrize("metric,value", READINGS)
def test_each_reader_reads_the_registry(metric, value, monkeypatch):
    monkeypatch.setattr(profiling, "SPANS", REGISTRY)
    assert harness.reader(metric)(_ctx()) == pytest.approx(value)
    assert harness.reader(metric)(_ctx(traj=0)) is None


@pytest.mark.parametrize("metric", [m for m, _ in READINGS])
def test_each_reader_finds_nothing_in_an_empty_registry(metric):
    assert profiling.SPANS == {}
    assert harness.reader(metric)(_ctx(counters={})) is None


def test_analyze_trace_families_are_the_frozen_copys():
    assert at.FAMILIES == frozen.FAMILIES
    for name, fam in (("chain_sum_kernel<float>", "K3 chain_sum"),
                      ("chain_matvec_long_kernel", "K4 chain_matvec"),
                      ("sigma_cap_kernel<float, 4>", "K5 sigma_cap"),
                      ("rotation_s_kernel", "K1 rotation_s")):
        assert at.family(name) == frozen.family(name) == fam


def _x(cat, name, ts, dur, tid=100, pid=100, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_analyze_trace_spans_by_launch_correlation(tmp_path):
    ev = [_x("user_annotation", "hmc_bench.period", 0, 2000),
          _x("user_annotation", "dwavehmc.sweep", 0, 1000),
          _x("user_annotation", "dwavehmc.leapfrog", 10, 600),
          _x("user_annotation", "dwavehmc.tracked_eigh", 20, 300),
          _x("user_annotation", "dwavehmc.anchor", 700, 290),
          _x("user_annotation", "dwavehmc.sync.eigh_info", 900, 80),
          _x("cpu_op", "aten::mm", 30, 20)]
    # (launch ts, category, kernel, device ts, device µs, correlation):
    # device work runs late, after its range has closed on the host
    work = [(35, "cuda_runtime", "rotation_s_kernel", 400, 50, 1),
            (40, "cuda_driver", "nvjet_tst_128x128", 460, 30, 2),
            (350, "cuda_runtime", "vectorized_elementwise_kernel", 500, 5, 3),
            (710, "cuda_runtime", "sm80_xmma_gemm_f32f32", 800, 40, 4),
            (910, "cuda_runtime", "void_sytrd4_gpu", 950, 100, 5),
            (1500, "cuda_runtime", "reduce_kernel", 1600, 7, 6)]
    for ts, cat, kernel, dts, dus, corr in work:
        ev.append(_x(cat, "cudaLaunchKernel", ts, 4, corr=corr))
        ev.append(_x("kernel", kernel, dts, dus, tid=7, pid=0, corr=corr))
    ev.append(_x("gpu_memcpy", "Memcpy DtoH", 1000, 3, tid=7, pid=0,
                 corr=7))
    ev.append(_x("cuda_runtime", "cudaMemcpyAsync", 960, 50, corr=7))
    # a launch on another host thread inside no range of its own
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", 50, 4, tid=200,
                 corr=8))
    ev.append(_x("kernel", "copy_kernel", 1700, 2, tid=7, pid=0, corr=8))
    path = tmp_path / "hand.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))

    spans = at.analyze(str(path), 5)["spans"]
    assert list(spans) == ["dwavehmc.sync.eigh_info", "dwavehmc.tracked_eigh",
                           "dwavehmc.anchor", at.NO_SPAN,
                           "dwavehmc.leapfrog"]
    eigh = spans["dwavehmc.tracked_eigh"]
    assert eigh["kernels"] == 2 and eigh["device_ms"] == pytest.approx(0.08)
    assert eigh["family_ms"] == pytest.approx({"K1 rotation_s": 0.05,
                                               "matmul": 0.03})
    assert spans["dwavehmc.leapfrog"]["family_ms"] == {"elementwise": 0.005}
    assert spans["dwavehmc.anchor"]["family_ms"] == {"matmul": 0.04}
    sync = spans["dwavehmc.sync.eigh_info"]
    assert sync["kernels"] == 1
    assert sync["family_ms"] == pytest.approx({"eigh": 0.1, "other": 0.003})
    assert spans[at.NO_SPAN]["kernels"] == 2
    assert "dwavehmc.sweep" not in spans
    assert at.span_device_time([e for e in ev if not e["name"].startswith(
        "dwavehmc.")]) == {}
