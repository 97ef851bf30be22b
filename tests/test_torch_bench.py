"""The port's headline benchmark (``drivers/bench.py``) against the JAX
script ``bench.py``, on the CPU at 4×4.

The helpers are the JAX script's; both benches hand their runners the same
arguments, mode by mode and leg by leg (each runner wrapped by a recorder
that passes the call through); the two JSON lines have the same keys, the
port adding ``peak_memory_gib`` per leg and ``leapfrog_unroll`` in each
leg's ``config``; a leg that raises is printed with its ``error`` and the
run exits nonzero.
"""

import importlib.util
import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch

from dwavehmc_tpu_torch.drivers import bench as tbench
from dwavehmc_tpu_torch.utils import flops

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: both benches at 4×4, batch 2, 1 therm sweep, 2-sweep segments, 1 rep,
#: the shape legs at L = 4 and b = 2
SMALL = {"BENCH_L": "4", "BENCH_BATCH": "2", "BENCH_THERM": "1",
         "BENCH_SWEEPS": "2", "BENCH_REPS": "1", "BENCH_PROD_L": "4",
         "BENCH_PROD_B": "2", "BENCH_CAP_L": "4", "BENCH_CAP_B": "2"}


@pytest.fixture(scope="module")
def jbench(tmp_path_factory):
    """The JAX script, loaded with its compilation cache under a temporary
    directory; JAX's cache setting is restored afterwards."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    old_cfg = jax.config.jax_compilation_cache_dir
    os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    jax.config.update("jax_compilation_cache_dir", old_cfg)
    if old_env is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = old_env


def test_helpers_equal_the_jax_script(jbench):
    for L in (4, 16, 24, 32):
        for Nt in (1, 6, 20):
            assert tbench.reference_cpu_traj_per_sec(L, Nt) == \
                jbench.reference_cpu_traj_per_sec(L, Nt)
    for scheme in ("ns", "exp2"):
        for K, r, p in ((1, 0, 0), (10, 6, 3), (4, 12, 4)):
            for args in ((16, 6, 8, 20, 6), (24, 6, 64, 10, 6),
                         (32, 6, 40, 4, 5), (24, 20, 8, 3, 6)):
                for ns in (1, 2):
                    assert flops.tracked_model_flops(
                        *args, K, r, p, ns, scheme) == \
                        jbench.tracked_model_flops(*args, K, r, p, ns,
                                                   scheme)


#: the arguments compared, by runner kind
FIELDS = {
    "init": ("n_chains", "exact_solver", "init_chunk"),
    "tracked": ("n_sweeps", "Nt", "dt", "measure", "tracked_iters",
                "anchor_every", "refine_iters", "polish_iters", "ns_steps",
                "rot_dtype", "rot_scheme", "exact_solver",
                "polish_precision", "polish_correction"),
    "exact": ("n_sweeps", "Nt", "dt", "measure", "eigh_mode"),
}


def _normal(value):
    if hasattr(value, "dtype") and not hasattr(value, "shape"):
        return str(value.dtype)
    if value is not None and "bfloat16" in str(value):
        return "bfloat16"
    if isinstance(value, float):
        return round(value, 12)
    return value


def _recorder(calls, kind, fn):
    sig = inspect.signature(fn)

    def wrapped(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        a = bound.arguments
        rec = {k: _normal(a[k]) for k in FIELDS[kind]}
        rec["L"] = a["lat"].Lx
        calls.append((kind, rec))
        return fn(*args, **kw)
    return wrapped


def _run_jax(jbench, monkeypatch, capsys):
    import dwavehmc_tpu.parallel.ensemble as jens

    calls = []
    monkeypatch.setattr(jbench, "init_ensemble_real", _recorder(
        calls, "init", jbench.init_ensemble_real))
    monkeypatch.setattr(jbench, "run_segment_real_jit", _recorder(
        calls, "exact", jbench.run_segment_real_jit))
    monkeypatch.setattr(jens, "run_segment_tracked", _recorder(
        calls, "tracked", jens.run_segment_tracked))
    capsys.readouterr()
    jbench.main()
    return calls, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_port(monkeypatch, capsys, argv=("--device", "cpu")):
    calls = []
    for name, kind in (("init_ensemble_real", "init"),
                       ("run_segment_real", "exact"),
                       ("run_segment_tracked", "tracked")):
        monkeypatch.setattr(tbench, name, _recorder(
            calls, kind, getattr(tbench, name)))
    capsys.readouterr()
    tbench.main(list(argv))
    return calls, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(obj, skip=()):
    if not isinstance(obj, dict):
        return None
    return {k: _keys(v, skip) for k, v in obj.items() if k not in skip}


def test_both_benches_give_their_runners_the_same_arguments(
        jbench, monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    jcalls, jline = _run_jax(jbench, monkeypatch, capsys)
    tcalls, tline = _run_port(monkeypatch, capsys)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for (kind, t), (_, j) in zip(tcalls, jcalls):
        assert t == j, kind
    # the schedule the JAX script runs: init, therm, three modes of 1 + 1
    # segments, then per leg init, therm and 1 + reps segments
    assert [c[0] for c in jcalls] == (
        ["init", "tracked"] + ["exact"] * 2 + ["tracked"] * 4
        + ["init", "tracked"] + ["tracked"] * 3
        + ["init", "tracked"] + ["tracked"] * 2)
    # the same keys; the port adds peak_memory_gib per leg and records
    # BENCH_LEAPFROG_UNROLL in each leg's config
    legs = ("production_24x24_b64", "capacity_32x32_b40")
    assert _keys(tline, legs) == _keys(jline, legs)
    for leg in legs:
        t = _keys(tline[leg], ("peak_memory_gib",))
        t["config"].pop("leapfrog_unroll")
        assert t == _keys(jline[leg])
        assert tline[leg]["peak_memory_gib"] is None       # no card here
    assert tline["metric"] == jline["metric"] == \
        "hmc_trajectories_per_sec_per_chip_4x4_b2_Nt6"
    for m, rec in tline["modes"].items():
        assert 0.0 <= rec["acceptance"] <= 1.0
        assert np.isfinite(rec["traj_per_sec"]) and rec["traj_per_sec"] > 0


def test_a_failing_leg_is_printed_and_the_run_exits_nonzero(monkeypatch,
                                                              capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_MODES", "tracked_fast")
    monkeypatch.setenv("BENCH_SKIP_EIGH", "1")
    monkeypatch.setenv("BENCH_CAPACITY", "0")

    def broken(*a, **k):
        raise RuntimeError("no ceiling here")

    monkeypatch.setattr(tbench, "matmul_ceiling_tflops", broken)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        tbench.main(["--device", "cpu"])
    assert e.value.code not in (0, None)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["production_24x24_b64"] == {
        "error": "RuntimeError: no ceiling here"}
    assert line["capacity_32x32_b40"] is None
    assert line["modes"]["tracked_fast"]["traj_per_sec"] > 0
    assert line["errors"] == ["production_24x24_b64: RuntimeError: no "
                              "ceiling here"]


def test_the_bench_asks_for_the_card_by_default(monkeypatch):
    assert tbench.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbench.bench(tbench.knobs({}), "cuda")
