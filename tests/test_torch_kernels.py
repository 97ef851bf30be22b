"""Port parity of the two kernels' plain versions, and their CPU dispatch.

K1 (rotation generator) plain vs the JAX XLA path in float64 and vs the
Pallas kernel in interpret mode in float32 (5e-6: the Pallas kernel's capped
atan series is within 2e-6, ``tests/test_pallas.py``).  K2 (weighted
Lorentzian sum) plain vs the Pallas kernel in interpret mode (rtol 2e-4, as
``tests/test_pallas.py``).  The kernels themselves are tested on the card in
``tests/test_torch_cuda.py``.
"""

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


def test_cpu_dispatch_never_counts_a_launch():
    kernels.reset_launches()
    tr, ti, d = (torch.as_tensor(x) for x in _rot_inputs(8, np.float32))
    kernels.rotation_s_parts(tr, ti, d, 0.1)
    omega, de, w2 = (torch.as_tensor(x) for x in _lor_inputs(3, 10, 1))
    kernels.weighted_lorentzian_sum(omega, de, w2, 0.1)
    assert kernels.LAUNCHES == {"rotation_s_parts": 0,
                                "weighted_lorentzian_sum": 0}


def test_launchers_refuse_cpu_tensors():
    tr, ti, d = (torch.as_tensor(x) for x in _rot_inputs(8, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rotation_s_parts_cuda(tr, ti, d, 0.1)
    omega, de, w2 = (torch.as_tensor(x) for x in _lor_inputs(3, 10, 1))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weighted_lorentzian_sum_cuda(omega, de, w2, 0.1)
