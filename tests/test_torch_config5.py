"""BASELINE config 5 (``drivers/demo_config5.py``) against the JAX script
``scripts/demo_config5.py`` on the CPU.

* ``mesh64`` at L = 4, 8 chains, under 2 gloo ranks on the JAX run's
  initial ensemble and draws, against the JAX ``mesh64_demo(out, 8, 4)`` on
  the 8 virtual devices of the tests' configuration: acceptance, distinct
  realizations (at 4×4 with n_imp = 0.05 each chain has one impurity, so
  two of the JAX run's eight share a site), finiteness and keys;
* ``mesh64`` (8 chains) and ``mesh_exec`` (5 chains, padded to 6) in
  float64 under 2 ranks bit-equal to the same calls in one process
  (initial and final disorder and Δ, accepts and dH);
* the memory plan at 32×32 equal to the JAX formula's for a given card
  size;
* each mode's JSON keys against the TPU artifacts ``examples/config5_*.json``;
* config 5's first thermalization sweep on one 16×16 chain (and, marked
  ``slow``, on two 32×32 chains) against the JAX package's on its draws.

Run as a script, this file is the ranks' program:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/test_torch_config5.py ROOT

The launch runs under its own time limit, so a deadlock fails the test.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dwavehmc_tpu_torch.drivers import demo_config5 as c5  # noqa: E402
from dwavehmc_tpu_torch.models.lattice import LatticeSpec  # noqa: E402
from dwavehmc_tpu_torch.parallel.ensemble import DrawStream  # noqa: E402

NPROC = 2
LAUNCH_SECONDS = 240
L, B64, B_EXEC = 4, 8, 5
CPU = torch.device("cpu")


def key_tree(d):
    """The nested keys of a JSON object, as sorted (path) tuples."""
    out = []
    for k, v in d.items():
        out.append((k,))
        if isinstance(v, dict):
            out += [(k, *sub) for sub in key_tree(v)]
    return sorted(out)


def quiet(msg):
    pass


def float64_runs(root: str, tag: str, min_ranks: int) -> None:
    """``mesh64`` and ``mesh_exec`` in float64 on the port's own draws."""
    c5.mesh64_demo(os.path.join(root, f"mesh64_f64_{tag}.json"), CPU,
                   batch=B64, L=L, min_ranks=min_ranks, dtype=torch.float64,
                   save_state=os.path.join(root, f"mesh64_f64_{tag}.npz"),
                   log=quiet)
    c5.mesh_exec_demo(os.path.join(root, f"exec_f64_{tag}.json"), CPU,
                      batch=B_EXEC, L=L, min_ranks=min_ranks,
                      dtype=torch.float64,
                      save_state=os.path.join(root, f"exec_f64_{tag}.npz"),
                      log=quiet)


# --- the ranks' program ---------------------------------------------------------

def _rank_main(root: str) -> None:
    from dwavehmc_tpu_torch.parallel.mesh import (
        maybe_setup_distributed, teardown_distributed)

    torch.set_num_threads(1)
    assert maybe_setup_distributed()
    try:
        d = np.load(os.path.join(root, "jax_draws.npz"))
        n = L * L
        stream = DrawStream(None, (B64, 2, n, 2), torch.float32, CPU,
                            d["normals"], d["uniforms"])
        c5.mesh64_demo(os.path.join(root, "mesh64_jax_draws.json"), CPU,
                       batch=B64, L=L, log=quiet, stream=stream,
                       init=(d["disorder"], d["delta_re"], d["delta_im"]))
        float64_runs(root, "ranks", 2)
        c5.mesh_demo(os.path.join(root, "mesh.json"), CPU, batch=B64, L=L,
                     log=quiet)
        c5.mesh_exec_demo(os.path.join(root, "mesh_exec.json"), CPU,
                          batch=B_EXEC, sweeps=2, L=L, log=quiet)
    finally:
        teardown_distributed()


# --- the tests ----------------------------------------------------------------

def launch(root: str) -> None:
    """This file as the program of NPROC gloo ranks, under a time limit
    after which the whole process group is killed."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", SKIP_QUICK_TESTS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(NPROC), os.path.abspath(__file__), root]
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=LAUNCH_SECONDS)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"{NPROC} ranks did not finish in {LAUNCH_SECONDS} s "
                    f"(deadlock?)\n{log[-4000:]}")
    assert proc.returncode == 0, log[-4000:]


def read(root, name):
    with open(os.path.join(root, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX ``mesh64_demo`` and its draws, the port's one-process float64
    runs, then one launch of the ranks."""
    import jax
    import jax.numpy as jnp

    from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
    from dwavehmc_tpu.models.params import make_params as jmake_params
    from dwavehmc_tpu.parallel import ensemble as jens

    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("config5"))
    jax_mod = _jax_script()
    jax_mod.mesh64_demo(os.path.join(root, "jax_mesh64.json"), B64, L)

    jp = jmake_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05,
                      beta=20.0, J=0.8, mass=1.0)
    js = jens.init_ensemble_real(JLat(L, L), jp, jax.random.PRNGKey(0), B64,
                                 dtype=jnp.float32, n_imp=0.05, init_chunk=8)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(js.key)
    normals = jax.vmap(lambda k: jax.random.normal(
        k, (2, L * L, 2), jnp.float32))(ks[:, 1])
    uniforms = jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32))(ks[:, 2])
    np.savez(os.path.join(root, "jax_draws.npz"),
             disorder=np.array(js.disorder), delta_re=np.array(js.delta_re),
             delta_im=np.array(js.delta_im), normals=np.array(normals)[None],
             uniforms=np.array(uniforms)[None])
    float64_runs(root, "one", 1)
    launch(root)
    return root


def _jax_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_demo_config5", os.path.join(REPO, "scripts", "demo_config5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh64_under_ranks_matches_the_jax_script(runs):
    want = read(runs, "jax_mesh64.json")
    got = read(runs, "mesh64_jax_draws.json")
    assert key_tree(got) == key_tree(want)
    assert got["devices"] == NPROC and want["devices"] == 8
    assert got["chains_per_device"] == B64 // NPROC
    for k in ("L", "batch", "Nt", "acceptance", "dH_finite",
              "distinct_disorder_realizations", "rho_s_shape",
              "rho_s_finite", "sigma_finite", "A_k0_finite"):
        assert got[k] == want[k], k
    assert got["dH_finite"] and got["rho_s_finite"] and got["sigma_finite"]
    assert got["A_k0_finite"]


@pytest.mark.parametrize("name", ["mesh64_f64", "exec_f64"])
def test_ranks_are_bit_equal_to_one_process_in_float64(runs, name):
    one = np.load(os.path.join(runs, f"{name}_one.npz"))
    ranks = np.load(os.path.join(runs, f"{name}_ranks.npz"))
    assert sorted(one.files) == sorted(ranks.files)
    batch = B64 if name == "mesh64_f64" else B_EXEC
    for k in one.files:
        assert one[k].shape[k in ("accepted", "dH")] == batch, k
        np.testing.assert_array_equal(ranks[k], one[k], err_msg=k)
    assert one["final_delta_re"].dtype == np.float64
    a, b = read(runs, f"{name}_one.json"), read(runs, f"{name}_ranks.json")
    assert (a["devices"], b["devices"]) == (1, NPROC)
    for k in ("acceptance", "distinct_disorder_realizations", "dH_finite"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("gib", [16, 80])
def test_memory_plan_matches_the_jax_formula(gib):
    from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
    from dwavehmc_tpu.utils.memory import estimate_memory, max_chains

    plan = c5.memory_plan(LatticeSpec(32, 32), gib * 2**30, 8)
    est8 = estimate_memory(JLat(32, 32), 8)
    assert plan["per_chain_mib"] == round(est8.per_chain_bytes / 2**20, 1)
    assert plan["chains_per_chip_8"] == round(est8.total_bytes / 2**30, 2)
    assert plan["max_chains_per_chip"] == max_chains(
        JLat(32, 32), hbm_bytes=gib * 2**30)
    assert f"{gib:.1f} GiB" in plan["note"]
    assert c5.memory_plan(LatticeSpec(32, 32), None, 2)[
        "max_chains_per_chip"] is None


def example(name):
    with open(os.path.join(REPO, "examples", name)) as f:
        return json.load(f)


def test_each_modes_keys_match_the_tpu_artifacts(runs, tmp_path):
    # mesh: the artifact predates the script's spelling of the 8-chain
    # figure (``chains_per_chip_8``, which the port keeps), and the port's
    # full_shape says why it compiles nothing
    want = [k if k != ("hbm_plan", "chains_per_chip_8_gib")
            else ("hbm_plan", "chains_per_chip_8")
            for k in key_tree(example("config5_mesh_demo.json"))]
    got = read(runs, "mesh.json")
    assert key_tree(got) == sorted(want + [("full_shape", "note")])
    assert got["full_shape"]["compiled"] == []
    assert got["reduced_exec"]["distinct_disorder_realizations"] == B64
    assert got["devices"] == NPROC
    for name, art in (("mesh_exec.json", "config5_mesh_exec.json"),
                      ("mesh64_jax_draws.json", "config5_mesh_64.json")):
        assert key_tree(read(runs, name)) == key_tree(example(art)), name
    ex = read(runs, "mesh_exec.json")
    assert ex["distinct_disorder_realizations"] == B_EXEC and ex["dH_finite"]

    # card (``tpu``): the artifact's keys, the allocator's peak and the
    # count of non-finite dH by stage run
    run = c5.card_demo(str(tmp_path / "card.json"), CPU, batch=2, sweeps=1,
                       L=L, therm=1, warmup=0, log=quiet)
    assert key_tree(run.report) == sorted(
        key_tree(example("config5_tpu_32x32.json"))
        + [("max_memory_allocated_gib",), ("nonfinite_dH",),
           ("nonfinite_dH", "therm"), ("nonfinite_dH", "timed")])
    assert read(tmp_path, "card.json") == run.report
    assert run.report["max_memory_allocated_gib"] is None   # no card


@pytest.mark.parametrize("L,chains,dtype,atol", [
    (16, 1, "float32", 1e-3),
    pytest.param(32, 2, "float32", 1e-3, marks=pytest.mark.slow),
    pytest.param(32, 2, "float64", 1e-8, marks=pytest.mark.slow)])
def test_first_therm_sweep_matches_the_jax_package(L, chains, dtype, atol):
    """Config 5's couplings (β = 20) and its first thermalization sweep
    (Nt = 20, 6 rotations per step, exact anchor) on one 16×16 chain, or on
    two chains at config 5's 32×32 (in float32, as config 5 runs, and in
    float64), on the JAX run's initial ensemble and draws: dH within
    ``atol`` and the same decisions.  The cold start's dH grows with the
    degrees of freedom, so at 32×32 the first sweeps are mostly rejected in
    both packages.  Each run prints both packages' per-chain dH; a
    float32 run also prints each package's float32 error, against the
    port's float64 sweep on the same inputs (the float32 state, params, dt
    and draws cast up; in float64 the two packages agree to 1e-8)."""
    import jax
    import jax.numpy as jnp

    from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
    from dwavehmc_tpu.models.params import make_params as jmake_params
    from dwavehmc_tpu.parallel import ensemble as jens
    from dwavehmc_tpu_torch.parallel.ensemble import (
        init_ensemble_real, run_segment_tracked)
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    torch.set_num_threads(2)
    n = L * L
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jmake_params(**c5.PHYS, dtype=jdt)
    js = jens.init_ensemble_real(JLat(L, L), jp, jax.random.PRNGKey(0),
                                 chains, dtype=jdt, n_imp=0.05)
    dt = calc_optimal_dt(20.0, 0.8, 1.0, 20)
    _, jseg = jens.run_segment_tracked(JLat(L, L), jp, js, 1, 20,
                                       jnp.full((chains,), dt, jdt),
                                       False, None, 0, 6)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(js.key)
    normals = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (2, n, 2), jdt))(ks[:, 1]))[None]
    uniforms = np.array(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32))(ks[:, 2]))[None]
    lat = LatticeSpec(L, L)
    params = c5.setup(CPU, tdt)
    st = init_ensemble_real(lat, params, None, chains, n_imp=0.05,
                            dtype=tdt, device=CPU,
                            disorder=torch.as_tensor(np.array(js.disorder)),
                            delta0_re=torch.as_tensor(np.array(js.delta_re)),
                            delta0_im=torch.as_tensor(np.array(js.delta_im)))
    dts = torch.full((chains,), dt, dtype=tdt)
    _, seg = run_segment_tracked(lat, params, st, 1, 20, dts, False,
                                 tracked_iters=6,
                                 normals=torch.as_tensor(normals),
                                 uniforms=torch.as_tensor(uniforms))
    print(f"{L}x{L} {dtype} first therm sweep dH: port "
          f"{seg.dH.numpy().tolist()}, "
          f"JAX {np.asarray(jseg.dH).tolist()}; accepted: port "
          f"{seg.accepted.numpy().tolist()}, JAX "
          f"{np.asarray(jseg.accepted).tolist()}")
    if tdt == torch.float32:
        up = lambda x: torch.as_tensor(np.array(x)).double()  # noqa: E731
        params64 = type(params)(*map(up, params))
        st64 = init_ensemble_real(lat, params64, None, chains, n_imp=0.05,
                                  dtype=torch.float64, device=CPU,
                                  disorder=up(js.disorder),
                                  delta0_re=up(js.delta_re),
                                  delta0_im=up(js.delta_im))
        _, ref = run_segment_tracked(
            lat, params64, st64, 1, 20, up(dts), False, tracked_iters=6,
            normals=up(normals), uniforms=torch.as_tensor(uniforms))
        ref = ref.dH.numpy()
        print(f"{L}x{L} float64 on the float32 inputs dH: {ref.tolist()}; "
              f"float32 error: port {(seg.dH.numpy() - ref).tolist()}, JAX "
              f"{(np.asarray(jseg.dH) - ref).tolist()}")
    np.testing.assert_allclose(seg.dH.numpy(), np.asarray(jseg.dH),
                               atol=atol)
    np.testing.assert_array_equal(seg.accepted.numpy(),
                                  np.asarray(jseg.accepted))


def test_mesh_modes_refuse_one_process(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for mode in ("mesh", "mesh_exec", "mesh64"):
        for dtype in ("float32", "float64"):
            with pytest.raises(RuntimeError, match="at least 2 ranks"):
                c5.main(["--mode", mode, "--device", "cpu", "--L", "4",
                         "--dtype", dtype])
    run = c5.main(["--mode", "card", "--device", "cpu", "--L", "4",
                   "--batch", "2", "--sweeps", "1", "--therm", "0",
                   "--warmup", "0"])
    assert run.report["therm_acceptance"] is None
    assert run.report["nonfinite_dH"] == {"timed": 0}
    assert (tmp_path / "runs" / "config5_tpu_32x32.json").exists()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
