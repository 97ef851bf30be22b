"""The cheap tracked sweep's CUDA graph (``parallel/cheap_graph.py``):

* on the CPU a segment never captures, and every cheap sweep runs eagerly
  under its ``dwavehmc.accept_cheap`` span;
* the shape gate on B·(2N)²: on at 16×16 with 8 chains and 24×24 with 4,
  off at 24×24 with 8 or 64 and 32×32 with 64;
* the signature changes with each Python-valued argument, the lattice,
  each tensor's dtype and shape, and each process-wide matmul setting;
* the cache: one capture a signature, a capture that raised not tried
  again, and no more than ``KEEP`` graphs kept;
* ``pairing_correlations_real`` copies its neighbour table from the host
  once a lattice and device;
* ``cheap_graph_pct``'s reader on a hand-made registry;
* on the card (marked ``cuda``, skips without one): graph and eager give
  bit-equal dH, accept flags and state over two anchor periods of the fast
  mix at 16×16 with 8 chains, β changed between the segments, and again
  after TF32 is switched on, which makes a new capture.

Imports only torch, the port and the benchmark's harness, so the card's
test runs on a machine without JAX.
"""

import importlib.util
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import forces_real, kernels
from dwavehmc_tpu_torch.parallel import cheap_graph, ensemble
from dwavehmc_tpu_torch.utils import profiling
from hmc_bench import harness

torch.set_num_threads(2)

SPEC = cheap_graph.CheapSpec(Nt=6, tracked_iters=6, refine_iters=6,
                             polish_iters=3, ns_steps=1,
                             rot_dtype=torch.bfloat16,
                             polish_precision="highest",
                             polish_correction=False, rot_scheme="exp2")
FAST = dict(tracked_iters=6, refine_iters=6, polish_iters=3, ns_steps=1,
            rot_dtype=torch.bfloat16, polish_precision="highest",
            rot_scheme="exp2", exact_solver="ph")
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, J=0.8, mass=1.0)


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_the_cpu_path_never_captures(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA graph was made on the CPU path")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    counts = dict(cheap_graph.COUNTS)
    lat = LatticeSpec(6, 6)
    p = make_params(beta=10.0, device="cpu", **PHYS)
    g = torch.Generator().manual_seed(3)
    s = ensemble.init_ensemble_real(lat, p, g, 2, n_imp=0.05,
                                    exact_solver="ph", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        s, seg = ensemble.run_segment_tracked(
            lat, p, s, 3, 2, 0.05, False, anchor_every=3, generator=g,
            **dict(FAST, tracked_iters=2, refine_iters=2, polish_iters=1))
    n = {k: v[0] for k, v in profiling.SPANS.items()}
    assert n["dwavehmc.accept_cheap"] == 2 and n["dwavehmc.anchor"] == 1
    assert "dwavehmc.cheap_graph" not in n
    assert cheap_graph.COUNTS == counts
    assert not cheap_graph.use_graph(s)
    assert bool(torch.isfinite(seg.dH).all())


@pytest.mark.parametrize("L,chains,on", [(16, 8, True), (24, 4, True),
                                         (24, 8, False), (24, 64, False),
                                         (32, 64, False)])
def test_the_shape_gate(L, chains, on):
    assert cheap_graph.graph_worthwhile(chains, 2 * L * L) is on


def _key_inputs(L=4, B=2, dtype=torch.float32):
    lat = LatticeSpec(L, L)
    N = lat.n_sites
    p = make_params(beta=10.0, device="cpu", dtype=dtype, **PHYS)
    z = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
    s = ensemble.HMCStateReal(z(B, N, 2), z(B, N, 2), z(B, N, 2),
                              z(B, N, 2), z(B, N), z(B, 2 * N),
                              z(B, 2 * N, 2 * N), z(B, 2 * N, 2 * N))
    return lat, p, s, torch.tensor(0.1, dtype=dtype)


CHANGED = dict(Nt=4, tracked_iters=3, refine_iters=12, polish_iters=4,
               ns_steps=2, rot_dtype=None, polish_precision="high",
               polish_correction=True, rot_scheme="ns")


@pytest.mark.parametrize("field", cheap_graph.CheapSpec._fields)
def test_the_key_changes_with_each_python_argument(field):
    lat, p, s, dt = _key_inputs()
    base = cheap_graph.sweep_key(lat, SPEC, p, s, dt)
    assert getattr(SPEC, field) != CHANGED[field]
    other = SPEC._replace(**{field: CHANGED[field]})
    assert cheap_graph.sweep_key(lat, other, p, s, dt) != base
    assert cheap_graph.sweep_key(lat, SPEC, p, s, dt) == base


def test_the_key_changes_with_the_lattice_and_the_tensors():
    lat, p, s, dt = _key_inputs()
    base = cheap_graph.sweep_key(lat, SPEC, p, s, dt)
    keys = [cheap_graph.sweep_key(LatticeSpec(4, 5), SPEC, p, s, dt),
            cheap_graph.sweep_key(lat, SPEC, *_key_inputs(B=3)[1:]),
            cheap_graph.sweep_key(lat, SPEC, *_key_inputs(
                dtype=torch.float64)[1:]),
            cheap_graph.sweep_key(lat, SPEC, p._replace(beta=torch.ones(2)),
                                  s, dt),
            cheap_graph.sweep_key(lat, SPEC, p, s, torch.full((2,), 0.1))]
    assert len({base, *keys}) == 1 + len(keys)


@pytest.fixture
def matmul_settings():
    """Restore every matmul setting a test changes (TF32's switches,
    torch's CPU one among them, reduced-precision reductions)."""
    m = torch.backends.cuda.matmul
    mk = getattr(torch.backends, "mkldnn", None)
    prior = (torch.get_float32_matmul_precision(), m.allow_tf32,
             getattr(m, "fp32_precision", None),
             getattr(getattr(mk, "matmul", None), "fp32_precision", None),
             m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    yield m
    if prior[2] is not None:
        m.fp32_precision = "none"
    torch.set_float32_matmul_precision(prior[0])
    m.allow_tf32 = prior[1]
    if prior[2] is not None:
        m.fp32_precision = prior[2]
    if prior[3] is not None:
        mk.matmul.fp32_precision = prior[3]
    m.allow_bf16_reduced_precision_reduction = prior[4]
    m.allow_fp16_reduced_precision_reduction = prior[5]


def _set_tf32(m):
    m.allow_tf32 = True


def _set_precision(m):
    torch.set_float32_matmul_precision("high")


def _set_fp32_precision(m):
    if not hasattr(m, "fp32_precision"):
        pytest.skip("this torch has no per-backend fp32_precision")
    m.fp32_precision = "tf32"


def _set_bf16(m):
    m.allow_bf16_reduced_precision_reduction = \
        not m.allow_bf16_reduced_precision_reduction


def _set_fp16(m):
    m.allow_fp16_reduced_precision_reduction = \
        not m.allow_fp16_reduced_precision_reduction


@pytest.mark.parametrize("change", [_set_tf32, _set_precision,
                                    _set_fp32_precision, _set_bf16,
                                    _set_fp16],
                         ids=lambda f: f.__name__[5:])
def test_the_key_changes_with_each_matmul_setting(change, matmul_settings):
    lat, p, s, dt = _key_inputs()
    base = cheap_graph.sweep_key(lat, SPEC, p, s, dt)
    change(matmul_settings)
    assert cheap_graph.sweep_key(lat, SPEC, p, s, dt) != base


def test_the_key_changes_with_the_blas_library(monkeypatch):
    lat, p, s, dt = _key_inputs()
    base = cheap_graph.sweep_key(lat, SPEC, p, s, dt)
    monkeypatch.setattr(torch.backends.cuda, "preferred_blas_library",
                        lambda *a: "cublaslt")
    assert cheap_graph.sweep_key(lat, SPEC, p, s, dt) != base


class _FakeGraph:
    """Stands in for a captured sweep: counts its replays."""

    def __init__(self, fail=False):
        if fail:
            raise RuntimeError("capture refused")
        self.replays = 0

    def replay(self, params, states, dt, normals, uniforms):
        self.replays += 1
        return states, None, None


def test_the_cache(monkeypatch):
    """One capture a signature, replays from then on; a capture that raised
    is not tried again; past ``KEEP`` signatures the one replayed longest
    ago goes."""
    fail = set()
    made = []

    def capture(lat, spec, params, state, dt, normals, uniforms):
        made.append(state.X.shape[0])
        return _FakeGraph(fail=state.X.shape[0] in fail)

    monkeypatch.setattr(cheap_graph, "use_graph", lambda states: True)
    monkeypatch.setattr(cheap_graph, "eager_sweep",
                        lambda lat, spec, params, states, *a, **k: (
                            states, types.SimpleNamespace(accepted=None,
                                                          dH=None)))
    monkeypatch.setattr(cheap_graph.CheapGraph, "capture", capture)
    monkeypatch.setattr(cheap_graph, "_draws", lambda s, n, u, g: (n, u))
    cheap_graph.reset_graphs()
    counts = dict(cheap_graph.COUNTS)

    def sweep(B):
        lat, p, s, dt = _key_inputs(B=B)
        return cheap_graph.cheap_sweep(lat, SPEC, p, s, dt)

    for _ in range(3):
        sweep(2)
    assert made == [2]
    (entry,) = cheap_graph._GRAPHS.values()
    assert entry.replays == 2
    fail.add(3)
    with pytest.warns(RuntimeWarning, match="left eager"):
        sweep(3)
    sweep(3)
    assert made == [2, 3]
    for B in range(4, 4 + cheap_graph.KEEP):
        sweep(B)
    assert len(cheap_graph._GRAPHS) == cheap_graph.KEEP
    assert made == [2, 3, *range(4, 4 + cheap_graph.KEEP)]
    sweep(2)                       # evicted: captured again
    assert made[-1] == 2 and len(cheap_graph._GRAPHS) == cheap_graph.KEEP
    assert {k: cheap_graph.COUNTS[k] - n for k, n in counts.items()} == {
        "captures": 2 + cheap_graph.KEEP, "replays": 0,
        "capture_failures": 1}
    cheap_graph.reset_graphs()


def test_the_neighbour_table_is_copied_once(monkeypatch):
    lat = LatticeSpec(3, 7)
    N = lat.n_sites
    g = torch.Generator().manual_seed(5)
    X = torch.randn((2, 2 * N, 2 * N), generator=g)
    Y = torch.randn((2, 2 * N, 2 * N), generator=g)
    e = torch.randn((2, 2 * N), generator=g)
    forces_real._nn_table.cache_clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first = forces_real.pairing_correlations_real(lat, e, X, Y,
                                                      torch.tensor(10.0))

        def refuse(*a, **k):
            raise AssertionError("the table was read from the host again")

        monkeypatch.setattr(forces_real, "neighbor_tables", refuse)
        again = forces_real.pairing_correlations_real(lat, e, X, Y,
                                                      torch.tensor(10.0))
    assert profiling.SPANS["dwavehmc.sync.forces_nn_table"][0] == 1
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _ctx(traj=80):
    return types.SimpleNamespace(traced_traj=traj,
                                 cfg=types.SimpleNamespace(n_chains=8))


def test_the_graph_share_reader(monkeypatch):
    read = harness.reader("cheap_graph_pct")
    monkeypatch.setattr(profiling, "SPANS", {
        "dwavehmc.sweep": [10, 1.0], "dwavehmc.cheap_graph": [9, 0.1],
        "dwavehmc.anchor": [1, 0.1]})
    assert read(_ctx()) == 100.0
    assert read(_ctx(traj=0)) is None
    monkeypatch.setattr(profiling, "SPANS", {
        "dwavehmc.sweep": [10, 1.0], "dwavehmc.accept_cheap": [9, 0.9]})
    assert read(_ctx()) == 0.0
    monkeypatch.setattr(profiling, "SPANS", {"dwavehmc.sweep": [1, 1.0],
                                             "dwavehmc.anchor": [1, 0.1]})
    assert read(_ctx()) is None
    # a program without the graph runner (the parent of this metric)
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "dwavehmc_tpu_torch.parallel."
        "cheap_graph" else real(name, *a))
    monkeypatch.setattr(profiling, "SPANS", {
        "dwavehmc.sweep": [10, 1.0], "dwavehmc.accept_cheap": [9, 0.9]})
    assert harness.reader("cheap_graph_pct")(_ctx()) is None


def _card_periods():
    """Two anchor periods (K = 10) of the fast mix at 16×16 with 8 chains
    on the card, β 10 then 12, from one start and one set of draws: a
    function that runs them, [(SegmentResult, end state)] each."""
    kernels.build()
    dev = torch.device("cuda")
    lat, B, K = LatticeSpec(16, 16), 8, 10
    g = torch.Generator(device=dev).manual_seed(17)
    p0 = make_params(beta=10.0, device=dev, **PHYS)
    s0 = ensemble.init_ensemble_real(lat, p0, g, B, n_imp=0.05,
                                     exact_solver="ph", device=dev)
    nrm = torch.randn((2 * K, B, 2, lat.n_sites, 2), generator=g, device=dev)
    u = torch.rand((2 * K, B), generator=g, device=dev)

    def run():
        s, out = s0, []
        for k, beta in enumerate((10.0, 12.0)):
            p = make_params(beta=beta, device=dev, **PHYS)
            s, seg = ensemble.run_segment_tracked(
                lat, p, s, K, 6, 0.148, False, anchor_every=K,
                normals=nrm[k * K:(k + 1) * K], uniforms=u[k * K:(k + 1) * K],
                **FAST)
            out.append((seg, s))
        torch.cuda.synchronize()
        return out
    return run


def _eager(monkeypatch, run):
    """``run()`` with every cheap sweep launched op by op."""
    with monkeypatch.context() as m:
        m.setattr(cheap_graph, "use_graph", lambda states: False)
        return run()


def _assert_same_bits(eager, graph):
    for (seg_e, s_e), (seg_g, s_g) in zip(eager, graph):
        assert torch.equal(seg_e.dH, seg_g.dH)
        assert torch.equal(seg_e.accepted, seg_g.accepted)
        for a, b in zip(s_e, s_g):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_and_eager_give_the_same_bits(monkeypatch):
    """Two anchor periods of the fast mix at 16×16 with 8 chains, β 10
    then 12: eager, then through the graph (one eager warm-up sweep, its
    capture, 17 replays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = _card_periods()
    cheap_graph.reset_graphs()
    eager = _eager(monkeypatch, run)
    counts = dict(cheap_graph.COUNTS)
    graph = run()
    K = 10
    assert cheap_graph.COUNTS["captures"] == counts["captures"] + 1
    assert cheap_graph.COUNTS["replays"] == counts["replays"] + 2 * (K - 1) - 1
    _assert_same_bits(eager, graph)
    cheap_graph.reset_graphs()


@pytest.mark.cuda
def test_a_matmul_setting_change_makes_a_new_capture(monkeypatch,
                                                     matmul_settings):
    """A graph captured with IEEE products, then TF32 switched on: the next
    cheap sweep captures anew, and its replays give the bits of the eager
    sweep under TF32, not those of the IEEE graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = _card_periods()
    cheap_graph.reset_graphs()
    matmul_settings.allow_tf32 = False
    ieee = run()
    counts = dict(cheap_graph.COUNTS)
    matmul_settings.allow_tf32 = True
    tf32 = run()
    assert cheap_graph.COUNTS["captures"] == counts["captures"] + 1
    assert len(cheap_graph._GRAPHS) == 2
    _assert_same_bits(_eager(monkeypatch, run), tf32)
    assert not torch.equal(ieee[0][0].dH, tf32[0][0].dH)
    cheap_graph.reset_graphs()
