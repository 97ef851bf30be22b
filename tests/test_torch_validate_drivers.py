"""Port parity for the drivers that validate the fast tracked
configuration, on the CPU: the JAX scripts themselves
(``scripts/validate_cheap_anchor.py``, ``scripts/validate_beta_extreme.py``,
loaded with ``importlib`` and run with a patched ``sys.argv``) against the
port's drivers.

* ``validate_cheap_anchor`` at 4×4, float32: the paired audit's cheap and
  exact dH per proposal within 1e-4 of the JAX script's on the JAX draws
  (its initial ensemble, and each sweep's (key', k_mom, k_acc) split
  replayed), the equilibrium chains' acceptance equal, and the report's
  keys equal;
* ``validate_beta_extreme`` on a tiny scan tree that the port's driver
  writes (4×4, the host float64 readout): ``--report_only`` of the JAX
  script on a copy of that tree gives the port's report, key for key.
"""

import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu_torch.drivers import validate_beta_extreme as vbe
from dwavehmc_tpu_torch.drivers import validate_cheap_anchor as vca
from dwavehmc_tpu_torch.parallel.ensemble import DrawStream

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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
    every sweep: normals (n, B, 2, N, 2) in ``dtype``, float32 uniforms
    (n, B)."""
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        normals.append(jax.vmap(lambda k: jax.random.normal(
            k, (2, n_sites, 2), dtype))(ks[:, 1]))
        uniforms.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32))(ks[:, 2]))
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


CHEAP_ARGS = ["--L", "4", "--batch", "2", "--Nt", "4", "--anchor_every", "2",
              "--refine_iters", "6", "--polish_iters", "3", "--therm", "2",
              "--paired", "3", "--sweeps", "4", "--exact_solver", "ph",
              "--dt_factor", "0.6"]


def test_paired_audit_matches_the_jax_script(monkeypatch, tmp_path):
    monkeypatch.setenv("SKIP_QUICK_TESTS", "1")
    calls = []
    accept = jens._tracked_accept_jit

    def recorder(*args, **kwargs):
        out = accept(*args, **kwargs)
        cheap = args[6] if len(args) > 6 else kwargs.get("cheap", False)
        calls.append((bool(cheap), np.asarray(out[1].dH, np.float64)))
        return out

    monkeypatch.setattr(jens, "_tracked_accept_jit", recorder)
    jax_out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["validate_cheap_anchor.py", *CHEAP_ARGS,
                                      "--out", str(jax_out)])
    jax_script("validate_cheap_anchor").main()
    want = json.loads(jax_out.read_text())

    ns = vca.parser().parse_args(CHEAP_ARGS + ["--device", "cpu"])
    therm, paired = ns.therm, ns.paired
    pairs = calls[therm:therm + 2 * paired]
    assert [c for c, _ in pairs] == [True, False] * paired

    # the JAX script's initial ensemble and every sweep's draws
    jp = jmake_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, beta=10.0,
                      J=0.8, mass=1.0, dtype=jnp.float32)
    js = jens.init_ensemble_real(JLat(4, 4), jp, jax.random.PRNGKey(0), 2,
                                 dtype=jnp.float32, n_imp=0.05,
                                 exact_solver="ph")
    normals, uniforms = segment_draws(js.key, therm + max(paired, ns.sweeps),
                                      16, jnp.float32)
    init = tuple(torch.as_tensor(np.array(x)) for x in
                 (js.disorder, js.delta_re, js.delta_im))
    report, audit = vca.validate(
        ns, init=init, stream=DrawStream(None, (2, 2, 16, 2), torch.float32,
                                         torch.device("cpu"), normals,
                                         uniforms),
        log=lambda s: None)

    np.testing.assert_allclose(audit.dH_cheap, [d for _, d in pairs[::2]],
                               atol=1e-4)
    np.testing.assert_allclose(audit.dH_exact, [d for _, d in pairs[1::2]],
                               atol=1e-4)
    assert audit.compared.all()
    assert key_tree(report) == key_tree(want)
    for chain in ("exact", "cheap"):
        assert (report["equilibrium"][chain]["acceptance"]
                == want["equilibrium"][chain]["acceptance"])
    assert report["paired_dH"]["n_samples"] == want["paired_dH"]["n_samples"]
    np.testing.assert_allclose(report["paired_dH"]["max_abs_err"],
                               want["paired_dH"]["max_abs_err"], atol=1e-4)
    assert report["config"] == want["config"]


def test_beta_extreme_report_matches_the_jax_script(monkeypatch, tmp_path,
                                                    capsys):
    monkeypatch.setenv("SKIP_QUICK_TESTS", "1")
    root = tmp_path / "port" / "beta_extreme_12x12"
    out = tmp_path / "port" / "report.json"
    monkeypatch.setattr(vbe, "L", 4)
    rep = vbe.main(["--device", "cpu", "--n_therm", "2",
                    "--n_measure", "3", "--anneal_stages", "1",
                    "--anneal_sweeps", "1", "--root", str(root),
                    "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    for p in rep["points"].values():
        assert p["dH_all_finite"]
    assert {"beta_10000", "beta_100000"} <= set(os.listdir(root))

    # the JAX script's --report_only on a copy of the tree, as its checkout
    here = tmp_path / "jax"
    shutil.copytree(root, here / "examples" / "beta_extreme_12x12")
    mod = jax_script("validate_beta_extreme")
    mod.__file__ = str(here / "scripts" / "validate_beta_extreme.py")
    monkeypatch.setattr(sys, "argv", ["validate_beta_extreme.py",
                                      "--report_only"])
    capsys.readouterr()
    mod.main()
    want = json.loads(
        (here / "examples" / "beta_extreme_validation.json").read_text())
    got = vbe.main(["--device", "cpu", "--report_only", "--root", str(root),
                    "--out", str(out)])
    assert key_tree(got) == key_tree(want)
    # the TPU's device-readout record is kept, under its TPU label
    assert "TPU" in got["device_readout_measured"]["note"]
    got.pop("device_readout_measured")
    want.pop("device_readout_measured")
    assert got == want
