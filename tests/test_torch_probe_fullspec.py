"""Port parity of the full-spec timing probe
(``drivers/probe_fullspec_timing.py``) against the JAX script
``scripts/probe_fullspec_timing.py`` on the CPU, at PROBE_L=4, PROBE_B=24
(one chain per β of the 24-point T grid).

The JAX script runs whole (two reps per leg); the port runs one rep per
leg on the JAX run's initial ensemble and sweep draws: its printed legs are
all there, ρ_s is finite, and the first sweep's accept decisions equal the
JAX script's, chain by chain.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu.utils.config import RunConfig as JRunConfig
from dwavehmc_tpu_torch.drivers import probe_fullspec_timing as probe
from dwavehmc_tpu_torch.parallel.ensemble import DrawStream

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_probe_matches_the_jax_script(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("PROBE_L", "4")
    monkeypatch.setenv("PROBE_B", "24")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "jax_probe_fullspec_timing",
        os.path.join(REPO, "scripts", "probe_fullspec_timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    accepted = []
    run = mod.run_segment_tracked

    def recorder(*args, **kwargs):
        st, seg = run(*args, **kwargs)
        accepted.append(np.asarray(seg.accepted))
        return st, seg

    monkeypatch.setattr(mod, "run_segment_tracked", recorder)
    mod.main()
    jax_log = capsys.readouterr().err
    assert "therm Nt=20 rep1" in jax_log and "transport rep1" in jax_log

    kn = probe.knobs()
    cfg = JRunConfig(Lx=4, Ly=4, W=1.0, n_imp=0.05, J=0.8)
    js = jens.init_ensemble_real(cfg.lattice(), cfg.params(),
                                 jax.random.PRNGKey(0), kn["B"],
                                 dtype=jnp.float32, n_imp=cfg.n_imp)
    normals, uniforms = segment_draws(js.key, 2, 16, jnp.float32)
    init = tuple(torch.as_tensor(np.array(x)) for x in
                 (js.disorder, js.delta_re, js.delta_im))
    lines = []
    out = probe.probe(kn, "cpu", reps=1, init=init, log=lines.append,
                      stream=DrawStream(None, (kn["B"], 2, 16, 2),
                                        torch.float32, torch.device("cpu"),
                                        normals, uniforms))

    for leg in ("therm Nt=20 rep0", "meas Nt=6 rep0", "transport rep0"):
        assert any(ln.startswith(leg) for ln in lines), (leg, lines)
    assert lines[0] == f"probe: 4x4 b24, n_omega={out['n_omega']}"
    assert np.isfinite(out["transport"][0]["rho0"])
    assert [leg["tag"] for leg in out["legs"]] == ["therm Nt=20",
                                                   "meas Nt=6"]
    # the first sweep: same initial ensemble, same draws
    np.testing.assert_array_equal(out["legs"][0]["accepted"],
                                  accepted[0][0])
    assert out["legs"][0]["acc"] == pytest.approx(accepted[0].mean())


def test_probe_main_runs_its_legs(monkeypatch, capsys):
    monkeypatch.setenv("PROBE_L", "4")
    monkeypatch.setenv("PROBE_B", "24")
    out = probe.main(["--device", "cpu"])
    err = capsys.readouterr().err
    for rep in (0, 1):
        for leg in ("therm Nt=20", "meas Nt=6", "transport"):
            assert f"{leg} rep{rep}:" in err
    assert len(out["legs"]) == 4 and len(out["transport"]) == 2
    assert all(np.isfinite(t["rho0"]) for t in out["transport"])
