"""Port parity for the run-directory IO and the checkpoint.

``dwavehmc_tpu_torch/utils/io.py`` must write byte-identical files to the
JAX package's module for the same inputs (CSV rows, ``resume_at``
truncation, spectra bins with partial-bin state, the tee log, JSON), so
either package's post-processing reads either's output.  The checkpoint
keeps the JAX field names for the state and round-trips the ensemble and
the torch generator.
"""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.sampler.hmc_real import HMCStateReal as JState
from dwavehmc_tpu.utils import checkpoint as jckpt
from dwavehmc_tpu.utils import io as jio
from dwavehmc_tpu_torch.models.bdg_real import (
    assemble_embedding,
    diagonalize_embedding,
    static_embedding,
)
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.parallel.ensemble import init_ensemble_real
from dwavehmc_tpu_torch.utils import checkpoint as tckpt
from dwavehmc_tpu_torch.utils import io as tio

torch.set_num_threads(2)

ROWS = [(1, 0, True, np.float32(-0.0123456789), 1.5, np.int64(7)),
        (1, 1, False, float("nan"), -2e-9, 3),
        (2, 0, True, np.float64(1e30), float("inf"), 0),
        (3, 1, False, 0.1, 123456789.0, np.int32(-4))]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(tmp_path, fn):
    """Run ``fn(module, directory)`` for each package; the two directories'
    files, by name."""
    out = {}
    for name, mod in (("jax", jio), ("torch", tio)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        fn(mod, str(d))
        out[name] = {f: _read(d / f) for f in sorted(os.listdir(d))}
    return out


def _assert_same_files(out):
    assert out["jax"].keys() == out["torch"].keys()
    for f, data in out["jax"].items():
        assert out["torch"][f] == data, f


def test_headers_equal():
    assert tio.OBS_HEADER == jio.OBS_HEADER
    assert tio.TRANS_HEADER == jio.TRANS_HEADER


def test_csv_rows_and_resume_truncation_are_byte_equal(tmp_path):
    def write(mod, d):
        w = mod.CsvWriter(os.path.join(d, "a.csv"), "Sweep,Chain,A,B,C,D")
        for r in ROWS:
            w.row(*r)
        w.close()
        # resume at sweep 2: rows of sweeps 1 and 2 are kept, sweep 3 goes
        w = mod.CsvWriter(os.path.join(d, "a.csv"), "Sweep,Chain,A,B,C,D",
                          resume_at=2)
        w.row(3, 0, True, 0.5, 0.25, 1)
        w.close()
        w = mod.CsvWriter(os.path.join(d, "b.csv"), "Sweep,X")
        w.row(1, 2.0)
        w.close()

    out = _both(tmp_path, write)
    _assert_same_files(out)
    lines = out["torch"]["a.csv"].decode().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "1", "2", "3"]


def test_spectra_bins_and_partial_state_are_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    meas = [{"opt_cond": rng.random((2, 5)), "dos": rng.random((2, 7)),
             "dos_AN": rng.random((2, 7)),
             "A_k0": rng.random((2, 4, 4)).astype(np.float32)}
            for _ in range(5)]
    meta = {"omega_grid": np.linspace(0.1, 1.0, 5), "Lx": 4, "Ly": 4,
            "T": 0.5, "eta": 0.25, "n_chains": 2}
    states = {}

    def write(mod, d):
        path = os.path.join(d, "spectra_bins.npz")
        st = mod.SpectraBinStore(path, 2, meta=meta)
        flushed = [st.add(i + 1, m) for i, m in enumerate(meas[:3])]
        assert flushed == [False, True, False]
        states[mod.__name__] = st.state_dict()
        # resume at sweep 3 with the partial bin restored
        st2 = mod.SpectraBinStore(path, 2, meta=meta, resume_at=3)
        st2.load_state(st.state_dict())
        assert st2.add(4, meas[3]) and not st2.add(5, meas[4])

    out = _both(tmp_path, write)
    _assert_same_files(out)
    sj, st = states[jio.__name__], states[tio.__name__]
    assert sj.keys() == st.keys()
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k])
    path = str(tmp_path / "torch" / "spectra_bins.npz")
    tmeta, tbins = tio.SpectraBinStore.load_bins(path)
    jmeta, jbins = jio.SpectraBinStore.load_bins(path)
    assert sorted(tbins) == sorted(jbins) == [2, 4]
    assert tmeta.keys() == jmeta.keys()


@pytest.mark.parametrize("verbose", [False, True])
def test_tee_log_and_json_are_byte_equal(tmp_path, monkeypatch, capsys,
                                         verbose):
    class Fixed(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5)

    monkeypatch.setattr(datetime, "datetime", Fixed)

    def write(mod, d):
        log = mod.TeeLogger(os.path.join(d, "scan.log"), verbose)
        log("Therm probe 5/5: acc [0.60, 1.00]")
        log("Scan done.")
        log.close()
        mod.write_json(os.path.join(d, "h.json"),
                       {"T_0.5": {"a": np.float32(0.25), "n": 3,
                                  "m": None}})

    out = _both(tmp_path, write)
    _assert_same_files(out)
    printed = capsys.readouterr().out
    assert printed.count("[2026-01-02 03:04:05] Scan done.") == (
        2 if verbose else 0)


def _state(seed=0):
    lat = LatticeSpec(4, 4)
    p = make_params(W=0.5, n_imp=0.25, beta=5.0, dtype=torch.float64,
                    device="cpu")
    g = torch.Generator().manual_seed(seed)
    s = init_ensemble_real(lat, p, g, 2, dtype=torch.float64, n_imp=0.25,
                           device="cpu")
    return lat, p, s._replace(pi_re=s.delta_re * 3.0, pi_im=s.delta_im - 1.0)


def test_checkpoint_round_trip(tmp_path):
    lat, p, s = _state()
    path = str(tmp_path / "ck.npz")
    g = torch.Generator().manual_seed(9)
    torch.rand(3, generator=g)
    extra = {"dt_m": np.array([0.1, 0.2]), "store0_bin_count": np.asarray(1)}
    tckpt.save_checkpoint(path, s, 12, extra=extra, generator=g)
    want_next = torch.rand(4, generator=g)

    g2 = torch.Generator().manual_seed(123)
    s2, idx, ex = tckpt.load_checkpoint(path, lat, p, state_path="real",
                                        generator=g2, device="cpu")
    assert idx == 12 and sorted(ex) == sorted(extra)
    np.testing.assert_array_equal(ex["dt_m"], extra["dt_m"])
    assert torch.equal(torch.rand(4, generator=g2), want_next)
    for name in ("delta_re", "delta_im", "pi_re", "pi_im", "disorder"):
        assert torch.equal(getattr(s2, name), getattr(s, name)), name
    w, X, _ = diagonalize_embedding(assemble_embedding(
        lat, static_embedding(lat, p.t, p.tp, p.mu, s.disorder), s.delta_re,
        s.delta_im))
    assert torch.equal(s2.evals, w) and torch.equal(s2.X, X)
    # the same file as the complex path's state, rediagonalized complex
    s3, idx3, _ = tckpt.load_checkpoint(path, lat, p, state_path="complex",
                                        device="cpu")
    assert idx3 == 12
    assert torch.equal(s3.delta, torch.complex(s.delta_re, s.delta_im))
    assert torch.equal(s3.pi, torch.complex(s.pi_re, s.pi_im))
    torch.testing.assert_close(s3.evals, w, rtol=0.0, atol=1e-12)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, lat, p, state_path="bogus", device="cpu")


def test_checkpoint_fields_match_jax_but_random_state_differs(tmp_path):
    """The state fields and ``extra_*`` are the JAX package's; the random
    state is the torch generator's own, under a name of its own."""
    _, _, s = _state(1)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_checkpoint(tpath, s, 4, extra={"dt_m": np.ones(2)},
                          generator=torch.Generator().manual_seed(0))
    js = JState(*(jnp.asarray(x.numpy()) for x in s),
                key=jax.vmap(jax.random.PRNGKey)(jnp.arange(2)))
    jckpt.save_checkpoint(jpath, js, 4, extra={"dt_m": np.ones(2)})
    with np.load(tpath) as t, np.load(jpath) as j:
        assert set(t.files) - {tckpt.GENERATOR_KEY} == set(j.files) - {"key"}
        for k in ("delta", "pi", "disorder", "sweep_idx", "extra_dt_m"):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k])
