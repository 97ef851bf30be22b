"""The card mode of BASELINE config 5 (``drivers/demo_config5.card_demo``)
against the JAX script's ``tpu_demo`` (``scripts/demo_config5.py``) on the
CPU.

``tpu_demo`` fixes L = 32; here its lattice is cut to 6×6 (its
``LatticeSpec`` is replaced for the call) and it runs 2 chains through its
own schedule: 10 exact-anchored therm sweeps at Nt = 20, 2 warm-up and 2
timed sweeps at Nt = 6 with K = 5 (refine 12 / polish 4, float32
rotations).  The port's ``card_demo`` runs the same schedule on the JAX
run's initial ensemble and every sweep's draws: per-sweep decisions equal
and dH within 1e-3, the acceptances and the JSON's JAX keys equal.  At
β = 20 float32 rounding alone moves a sweep's dH by a few 1e-4 in either
package (the first therm sweep of these chains: the JAX run 2.8e-4 from
the port's float64 value, the port's float32 run 1.3e-4, and the port's
float32 value moves by 1e-4 with the CPU thread count).  The script is
loaded with ``importlib`` and writes into ``tmp_path``.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dwavehmc_tpu.models.lattice as jlattice
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.parallel import ensemble as jens
from dwavehmc_tpu_torch.drivers import demo_config5 as c5
from dwavehmc_tpu_torch.parallel.ensemble import DrawStream

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, B, SWEEPS = 6, 2, 2
#: tpu_demo's fixed schedule: therm sweeps, then warm-up sweeps
THERM, WARMUP = 10, 2


def segment_draws(keys, n_sweeps, n_sites):
    """Each sweep's draws of chains whose keys split (key', k_mom, k_acc)
    every sweep: normals (n, B, 2, N, 2), uniforms (n, B)."""
    normals, uniforms = [], []
    for _ in range(n_sweeps):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        normals.append(jax.vmap(lambda k: jax.random.normal(
            k, (2, n_sites, 2), jnp.float32))(ks[:, 1]))
        uniforms.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32))(ks[:, 2]))
    return np.array(jnp.stack(normals)), np.array(jnp.stack(uniforms))


def test_card_mode_matches_the_jax_tpu_demo(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_demo_config5", os.path.join(REPO, "scripts", "demo_config5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    JLat = jlattice.LatticeSpec
    monkeypatch.setattr(jlattice, "LatticeSpec", lambda Lx, Ly: JLat(L, L))
    segs = []
    run = jens.run_segment_tracked

    def recorder(*args, **kwargs):
        st, seg = run(*args, **kwargs)
        segs.append((np.asarray(seg.accepted),
                     np.asarray(seg.dH, np.float64)))
        return st, seg

    monkeypatch.setattr(jens, "run_segment_tracked", recorder)
    mod.tpu_demo(str(tmp_path / "jax.json"), B, SWEEPS)
    want = json.loads((tmp_path / "jax.json").read_text())
    monkeypatch.undo()

    jp = jmake_params(**c5.PHYS)
    js = jens.init_ensemble_real(JLat(L, L), jp, jax.random.PRNGKey(0), B,
                                 dtype=jnp.float32, n_imp=0.05, init_chunk=8)
    n = L * L
    normals, uniforms = segment_draws(js.key, THERM + WARMUP + SWEEPS, n)
    stream = DrawStream(None, (B, 2, n, 2), torch.float32,
                        torch.device("cpu"), normals, uniforms)
    got = c5.card_demo(str(tmp_path / "port.json"), torch.device("cpu"),
                       batch=B, sweeps=SWEEPS, L=L, therm=THERM,
                       warmup=WARMUP, stream=stream, log=lambda s: None,
                       init=tuple(np.array(x) for x in (
                           js.disorder, js.delta_re, js.delta_im)))

    assert [len(a) for a, _ in segs] == [THERM, WARMUP, SWEEPS]
    acc = np.concatenate([a for a, _ in segs])
    dH = np.concatenate([d for _, d in segs])
    np.testing.assert_array_equal(got.accepted, acc)
    np.testing.assert_allclose(got.dH, dH, atol=1e-3)
    # the script writes its fixed L = 32 whatever lattice it ran
    assert (got.report["L"], want["L"]) == (L, 32)
    for k in ("batch", "Nt", "sweeps", "acceptance", "therm_acceptance",
              "hbm_est_gib"):
        assert got.report[k] == want[k], k
    assert set(want) < set(got.report)
    assert got.report["nonfinite_dH"] == {
        "therm": int((~np.isfinite(dH[:THERM])).sum()),
        "warmup": int((~np.isfinite(dH[THERM:THERM + WARMUP])).sum()),
        "timed": int((~np.isfinite(dH[THERM + WARMUP:])).sum())}
