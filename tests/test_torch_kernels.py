"""Port parity of the two kernels' plain versions, and their CPU dispatch.

K1 (rotation generator) plain vs the JAX XLA path in float64 and vs the
Pallas kernel in interpret mode in float32 (5e-6: the Pallas kernel's capped
atan series is within 2e-6, ``tests/test_pallas.py``).  K2 (weighted
Lorentzian sum) plain vs the Pallas kernel in interpret mode (rtol 2e-4, as
``tests/test_pallas.py``).  The kernels themselves are tested on the card in
``tests/test_torch_cuda.py``.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.ops.pallas_kernels import rotation_s_parts as jrot_pallas
from dwavehmc_tpu.ops.pallas_kernels import weighted_lorentzian_sum as jlor
from dwavehmc_tpu.ops.tracked_eigh import rotation_matrix_parts as jrot
from dwavehmc_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _rot_inputs(n, dtype, batch=2, seed=0):
    rng = np.random.default_rng(seed + n)
    a = rng.normal(size=(batch, n, n))
    b = rng.normal(size=(batch, n, n))
    tr = (a + a.transpose(0, 2, 1)) * 0.01
    ti = (b - b.transpose(0, 2, 1)) * 0.01
    d = np.sort(rng.normal(size=(batch, n)), axis=-1) * 3.0
    return (x.astype(dtype) for x in (tr, ti, d))


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("n", [32, 65])
def test_rotation_plain_matches_xla_f64(n):
    tr, ti, d = _rot_inputs(n, np.float64)
    tr[0, 0, 1] = ti[0, 0, 1] = 0.0          # |T| = 0 entry → S = 0
    want = jax.vmap(jrot)(jnp.asarray(tr), jnp.asarray(ti), jnp.asarray(d))
    got = kernels.rotation_s_parts_plain(torch.as_tensor(tr),
                                         torch.as_tensor(ti),
                                         torch.as_tensor(d), 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-12)


@pytest.mark.parametrize("n", [256, 300])
def test_rotation_plain_matches_pallas_interpret_f32(n):
    tr, ti, d = _rot_inputs(n, np.float32, batch=1)
    want = jrot_pallas(jnp.asarray(tr[0]), jnp.asarray(ti[0]),
                       jnp.asarray(d[0]), 0.1, interpret=True)
    got = kernels.rotation_s_parts(torch.as_tensor(tr), torch.as_tensor(ti),
                                   torch.as_tensor(d), 0.1)
    for g, w in zip(got, want):
        assert float(np.max(np.abs(_np(g)[0] - np.asarray(w)))) < 5e-6


def _lor_inputs(n_w, M, batch, seed=0):
    rng = np.random.default_rng(seed)
    omega = np.stack([np.linspace(0.01, 4.0, n_w)] * batch).astype(np.float32)
    de = rng.normal(scale=2.0, size=(batch, M)).astype(np.float32)
    w2 = rng.uniform(size=(batch, M)).astype(np.float32)
    return omega, de, w2


def test_lorentzian_plain_matches_pallas_interpret():
    omega, de, w2 = _lor_inputs(37, 1000, batch=2)
    eta = 0.05
    got = _np(kernels.weighted_lorentzian_sum(
        *(torch.as_tensor(x) for x in (omega, de, w2)), eta))
    for b in range(2):
        want = np.asarray(jlor(jnp.asarray(omega[b]), jnp.asarray(de[b]),
                               jnp.asarray(w2[b]), eta, interpret=True))
        np.testing.assert_allclose(got[b], want, rtol=2e-4)


@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_lorentzian_plain_chunking_matches_dense_oracle(chunk):
    omega, de, w2 = (x.astype(np.float64) for x in _lor_inputs(37, 500, 2, 1))
    eta = 0.2
    x = omega[:, :, None] - de[:, None, :]
    want = np.einsum("bkm,bm->bk", (eta / np.pi) / (x * x + eta * eta), w2)
    got = kernels.weighted_lorentzian_sum_plain(
        *(torch.as_tensor(v) for v in (omega, de, w2)), eta, chunk=chunk)
    np.testing.assert_allclose(_np(got), want, rtol=1e-12)


def _hop_inputs(L=3, batch=2):
    """(hr, hi, ur, ui, K6's table) of a random H with the BdG pattern of
    an L×L lattice and a random U, float32 on the CPU."""
    from dwavehmc_tpu_torch.models.bdg_real import hamiltonian_columns
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec

    cols, nnz = hamiltonian_columns(LatticeSpec(L, L))
    n = cols.shape[0]
    rng = np.random.default_rng(L)
    mask = np.zeros((n, n), dtype=bool)
    for r in range(n):
        mask[r, cols[r, :nnz[r]]] = True
    hr, hi, ur, ui = (torch.as_tensor(
        rng.normal(size=(batch, n, n)) * (mask if k < 2 else 1.0),
        dtype=torch.float32) for k in range(4))
    return hr, hi, ur, ui, kernels.bdg_hop_table(cols, nnz, "cpu")


def test_cpu_dispatch_never_counts_a_launch():
    kernels.reset_launches()
    tr, ti, d = (torch.as_tensor(x) for x in _rot_inputs(8, np.float32))
    kernels.rotation_s_parts(tr, ti, d, 0.1)
    omega, de, w2 = (torch.as_tensor(x) for x in _lor_inputs(3, 10, 1))
    kernels.weighted_lorentzian_sum(omega, de, w2, 0.1)
    kernels.chain_sum(tr)
    kernels.spectral_norm_est(tr, ti)
    hr, hi, ur, ui, table = _hop_inputs()
    kernels.bdg_hop(hr, hi, table, ur, ui)
    assert kernels.LAUNCHES == {"rotation_s_parts": 0,
                                "weighted_lorentzian_sum": 0,
                                "chain_sum": 0, "sigma_cap": 0,
                                "bdg_hop": 0,
                                "hu_dense": 0}


def test_launchers_refuse_cpu_tensors():
    tr, ti, d = (torch.as_tensor(x) for x in _rot_inputs(8, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rotation_s_parts_cuda(tr, ti, d, 0.1)
    omega, de, w2 = (torch.as_tensor(x) for x in _lor_inputs(3, 10, 1))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weighted_lorentzian_sum_cuda(omega, de, w2, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.chain_sum_cuda(d)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.spectral_norm_est_cuda(tr, ti)
    hr, hi, ur, ui, table = _hop_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bdg_hop_cuda(hr, hi, table, ur, ui)


def test_build_names_its_files_per_process(tmp_path, monkeypatch):
    """Ranks building a fresh checkout at once must not share a file: the
    object files carry the process id, are removed after the link, and the
    library is renamed into place.  A stand-in compiler writes its ``-o``
    file and records the command."""
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('x')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_load", lambda path: path)
    monkeypatch.setattr(kernels, "_lib", None)
    info = kernels.build(force=True)
    lib = Path(info["library"])
    assert lib.exists() and lib.parent == tmp_path / "kernels"
    outs = [ln.split(" -o ")[1].split()[0]
            for ln in calls.read_text().splitlines()]
    objs = [o for o in outs if o.endswith(".o")]
    assert len(objs) == len(kernels.SOURCES)
    assert all(f".{os.getpid()}.o" in o for o in objs)
    assert not any(Path(o).exists() for o in objs)
    assert list(lib.parent.iterdir()) == [lib]
    monkeypatch.setattr(os, "getpid", lambda: 12345)
    assert all(kernels._object_path(lib, s) != Path(o)
               for s, o in zip(kernels.SOURCES, objs))
