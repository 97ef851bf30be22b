"""What the measured process may hold: the port, and never JAX or the
JAX package, compared by whole top-level module name; the reference
imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from hmc_bench import harness
from hmc_bench.run import FORBIDDEN, forbidden_modules


@pytest.mark.parametrize("modules,found", [
    (["dwavehmc_tpu_torch", "dwavehmc_tpu_torch.ops.kernels", "numpy"], []),
    (["dwavehmc_tpu", "torch"], ["dwavehmc_tpu"]),
    (["dwavehmc_tpu.models.bdg"], ["dwavehmc_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "dwavehmc_tpu_torchx"], []),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert forbidden_modules(modules) == found


def test_a_run_loads_no_jax():
    """Import every module a run uses, the program's entry included, in a
    fresh interpreter: nothing forbidden is loaded."""
    code = (
        "import sys\n"
        "import hmc_bench.run, hmc_bench.check, hmc_bench.calibrate\n"
        "from hmc_bench import harness\n"
        "import dwavehmc_tpu_torch.drivers.simulation\n"
        "for m in harness.load_benchmark()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "print(hmc_bench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        found = _imports(path)
        assert not found & (FORBIDDEN | {"dwavehmc_tpu_torch"}), path
        assert found <= {"__future__", "functools", "math", "numpy",
                         "torch"}, (path, found)


def test_no_harness_file_imports_jax():
    for path in harness.HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
