"""Port parity of the rank layout (``dwavehmc_tpu_torch/parallel/mesh.py``)
against the JAX package's device mesh (``dwavehmc_tpu/parallel/mesh.py``,
whose tests use the conftest's 8 virtual CPU devices), and a round trip of
a global batch through 4 gloo ranks.

Run as a script, this file is one rank of the round trip:

    python tests/test_torch_mesh.py RANK PORT OUT_DIR
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dwavehmc_tpu_torch.parallel import mesh as tmesh  # noqa: E402

ENV_NAMES = ("DWAVEHMC_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
             "DWAVEHMC_NUM_PROCESSES", "JAX_NUM_PROCESSES",
             "DWAVEHMC_PROCESS_ID", "JAX_PROCESS_ID", "DWAVEHMC_DISTRIBUTED",
             "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK")
NPROC = 4
ROUND_TRIP_SECONDS = 120


@pytest.fixture
def jmesh():
    from dwavehmc_tpu.parallel import mesh

    return mesh


@pytest.fixture
def bare_env(monkeypatch):
    for k in ENV_NAMES:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _common(spec):
    return None if spec is None else {k: spec[k] for k in (
        "coordinator_address", "num_processes", "process_id")}


def test_env_spec_matches_jax(jmesh, bare_env):
    assert tmesh.distributed_env_spec() is None
    assert jmesh.distributed_env_spec() is None
    bare_env.setenv("DWAVEHMC_COORDINATOR", "10.0.0.1:1234")
    bare_env.setenv("DWAVEHMC_NUM_PROCESSES", "4")
    bare_env.setenv("DWAVEHMC_PROCESS_ID", "2")
    assert _common(tmesh.distributed_env_spec()) == \
        jmesh.distributed_env_spec()
    for k in ("DWAVEHMC_COORDINATOR", "DWAVEHMC_NUM_PROCESSES",
              "DWAVEHMC_PROCESS_ID"):
        bare_env.delenv(k)
    bare_env.setenv("DWAVEHMC_DISTRIBUTED", "1")
    assert _common(tmesh.distributed_env_spec()) == \
        jmesh.distributed_env_spec()


@pytest.mark.parametrize("world,want", [
    ("1", None),
    ("4", {"coordinator_address": "127.0.0.1:29511", "num_processes": 4,
           "process_id": 3, "local_rank": 1})])
def test_env_spec_reads_torchrun(bare_env, world, want):
    """torchrun's variables stand in for the JAX_* spellings; a world of
    one process is no process group."""
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29511"),
                 ("WORLD_SIZE", world), ("RANK", "3"), ("LOCAL_RANK", "1")):
        bare_env.setenv(k, v)
    assert tmesh.distributed_env_spec() == want


def test_single_process_is_one_rank(bare_env):
    assert not tmesh.setup_distributed()
    assert not tmesh.maybe_setup_distributed()
    assert tmesh.world() == (0, 1)
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    assert tmesh.any_across_ranks(True) and not tmesh.any_across_ranks(False)
    x = {"a": np.arange(3)}
    np.testing.assert_array_equal(tmesh.gather_global_batch(x)["a"], x["a"])


def test_distribute_defaults_to_the_card(bare_env):
    """Without ``device`` a rank's slice goes to its card: with none it
    raises, it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.distribute_global_batch({"a": np.arange(4)})


@pytest.mark.parametrize("grid_points", [None, 4, 3, 2])
def test_layouts_match_jax_mesh(jmesh, grid_points):
    jm = jmesh.make_ensemble_mesh(grid_points)
    tm = tmesh.make_ensemble_mesh(grid_points, n_ranks=8)
    assert tm.ranks.shape == jm.devices.shape
    assert tm.axis_names == jm.axis_names
    if grid_points is not None:
        assert tmesh.make_mesh_2d(grid_points, n_ranks=8).ranks.shape == \
            jmesh.make_mesh_2d(grid_points).devices.shape
    else:
        assert tmesh.make_mesh_1d(n_ranks=8).ranks.shape == \
            jmesh.make_mesh_1d().devices.shape


@pytest.mark.parametrize("grid_points", [None, 4, 3])
def test_rank_slices_are_the_jax_shards(jmesh, grid_points):
    """Rank r's slice is the block the JAX sharding P(axis_names) gives the
    r-th device of its mesh, in the mesh's flat order."""
    jm = jmesh.make_ensemble_mesh(grid_points)
    tm = tmesh.make_ensemble_mesh(grid_points, n_ranks=8)
    shards = jmesh.grid_chain_sharding(jm).devices_indices_map((16,))
    for r, dev in enumerate(jm.devices.flat):
        assert tmesh.process_batch_slice(16, tm, rank=r) == shards[dev][0]
    with pytest.raises(ValueError):
        tmesh.process_batch_slice(13, tm, rank=0)
    with pytest.raises(ValueError):
        jmesh.process_batch_slice(13, jm)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _round_trip_rank(rank: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    assert tmesh.setup_distributed(f"localhost:{port}", NPROC, rank)
    try:
        layout = tmesh.make_ensemble_mesh(grid_points=2)
        n_total = 16
        glob = {"a": np.arange(n_total, dtype=np.float32),
                "b": np.arange(3 * n_total, dtype=np.float64).reshape(
                    n_total, 3)}
        local = tmesh.distribute_global_batch(glob, layout, device="cpu")
        back = tmesh.gather_global_batch(local)
        to0 = tmesh.gather_global_batch(local, dst=0)
        sl = tmesh.process_batch_slice(n_total, layout)
        res = {"world": list(tmesh.world()), "slice": [sl.start, sl.stop],
               "local_a": local["a"].tolist(),
               "back": all(np.array_equal(back[k], glob[k]) for k in glob),
               "to0": (to0 is None if rank else
                       all(np.array_equal(to0[k], glob[k]) for k in glob)),
               "any_rank3": tmesh.any_across_ranks(rank == 3),
               "any_none": tmesh.any_across_ranks(False)}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        tmesh.teardown_distributed()


def test_round_trip_over_four_gloo_ranks(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    for k in ENV_NAMES:
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(NPROC)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=ROUND_TRIP_SECONDS)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    os.killpg(q.pid, signal.SIGKILL)
            pytest.fail("the gloo round trip did not finish in "
                        f"{ROUND_TRIP_SECONDS} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    for r in range(NPROC):
        with open(tmp_path / f"rank{r}.json") as f:
            got = json.load(f)
        assert got["world"] == [r, NPROC]
        assert got["slice"] == [4 * r, 4 * r + 4]
        assert got["local_a"] == list(range(4 * r, 4 * r + 4))
        assert got["back"] and got["to0"]
        assert got["any_rank3"] and not got["any_none"]


if __name__ == "__main__":
    _round_trip_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
