"""Port parity of the 32×32 demonstration (``drivers/demo_32x32.py``)
against the JAX script ``scripts/demo_32x32.py`` on the CPU.

The JAX script runs at DEMO_L=4, batch 2, 2 therm and 2 × 3 measured sweeps
with float32 rotations (bf16 rounding differs between XLA and PyTorch on
the CPU, so the bf16 default is held on the card only), loaded with
``importlib`` and pointed at ``tmp_path`` (its ``__file__``), so that
``examples/`` is not written.  The port runs on the JAX run's initial
ensemble and every sweep's draws: per-sweep acceptance equal, dH within
1e-4, ρ_s and σ_DC within rtol 1e-3 (float32), and the JSON's key tree
equal to the JAX run's and to ``examples/demo_32x32.json``'s.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu_torch.drivers import demo_32x32 as demo
from dwavehmc_tpu_torch.parallel.ensemble import DrawStream

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"DEMO_L": "4", "DEMO_BATCH": "2", "DEMO_THERM": "2",
       "DEMO_SWEEPS": "3", "DEMO_ROT_DTYPE": "float32"}


def jax_script(name, here):
    """The JAX script ``name`` as a module whose checkout is ``here``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.__file__ = str(here / "scripts" / f"{name}.py")
    (here / "examples").mkdir(parents=True, exist_ok=True)
    return mod


def key_tree(d):
    """The nested keys of a JSON object, as sorted (path) tuples."""
    out = []
    for k, v in d.items():
        out.append((k,))
        if isinstance(v, dict):
            out += [(k, *sub) for sub in key_tree(v)]
    return sorted(out)


def segment_draws(keys, n_sweeps, n_sites, dtype):
    """Each sweep's draws of chains whose keys split (key', k_mom, k_acc)
    every sweep: normals (n, B, 2, N, 2), float32 uniforms (n, B)."""
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        normals.append(jax.vmap(lambda k: jax.random.normal(
            k, (2, n_sites, 2), dtype))(ks[:, 1]))
        uniforms.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32))(ks[:, 2]))
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


def test_demo_matches_the_jax_script(monkeypatch, tmp_path):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    update = jax.config.update
    # the script would point JAX's persistent cache at its checkout
    monkeypatch.setattr(jax.config, "update", lambda name, val: None if (
        name == "jax_compilation_cache_dir") else update(name, val))
    segs = []
    run = jens.run_segment_tracked

    def recorder(*args, **kwargs):
        st, seg = run(*args, **kwargs)
        segs.append((np.asarray(seg.accepted), np.asarray(seg.dH, np.float64)))
        return st, seg

    monkeypatch.setattr(jens, "run_segment_tracked", recorder)
    mod = jax_script("demo_32x32", tmp_path)
    monkeypatch.chdir(tmp_path)
    mod.main()
    want = json.loads((tmp_path / "examples" / "demo_32x32.json").read_text())

    kn = demo.knobs()
    B, n = kn["batch"], 16
    jp = jmake_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05,
                      beta=10.0, J=0.8, mass=1.0, dtype=jnp.float32)
    js = jens.init_ensemble_real(JLat(4, 4), jp, jax.random.PRNGKey(0), B,
                                 dtype=jnp.float32, n_imp=0.05)
    normals, uniforms = segment_draws(js.key, kn["therm"] + 2 * kn["sweeps"],
                                      n, jnp.float32)
    init = tuple(torch.as_tensor(np.array(x)) for x in
                 (js.disorder, js.delta_re, js.delta_im))
    stream = DrawStream(None, (B, 2, n, 2), torch.float32,
                        torch.device("cpu"), normals, uniforms)
    got, _, port_segs = demo.demo(kn, "cpu", init=init, stream=stream,
                                  log=lambda s: None)

    assert len(port_segs) == len(segs) == 3
    for (acc, dH), seg in zip(segs, port_segs):
        np.testing.assert_array_equal(seg.accepted.numpy(), acc)
        np.testing.assert_allclose(seg.dH.double().numpy(), dH, atol=1e-4)
    for k in ("superfluid_stiffness", "dc_conductivity"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    for k in ("acceptance", "acceptance_therm"):
        assert got[k] == want[k]
    assert got["finite"] and want["finite"]
    assert got["config"] == want["config"]
    example = json.loads(open(os.path.join(REPO, "examples",
                                           "demo_32x32.json")).read())
    assert key_tree(got) == key_tree(want) == key_tree(example)
    assert got["device"] == "cpu"


def test_main_writes_under_runs(monkeypatch, tmp_path, capsys):
    for k, v in dict(ENV, DEMO_THERM="1", DEMO_SWEEPS="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    out = demo.main(["--device", "cpu"])
    written = json.loads((tmp_path / "runs" / "demo_32x32.json").read_text())
    assert written == json.loads(json.dumps(out))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["finite"] and line["L"] == 4
