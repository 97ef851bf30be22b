"""Per-chain sums that give a chain the same bits whatever its batch
(ROADMAP fault F6), on the CPU, in float32 and float64.

The HMC energies' sums (``sampler/hmc_real``) add through K3 ``chain_sum``
and the σ-cap's power iteration (``ops/tracked_eigh``) through K5, whose
plain version is built on ``chain_matvec_plain`` and K3's (``ops/kernels``);
the plain versions run the kernels' halving tree: a block of a batch alone
gets the bits it gets inside the batch.  Their values agree with a plain sum
and with the JAX functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.ops import tracked_eigh as jte
from dwavehmc_tpu.sampler import hmc_real as jhmc
from dwavehmc_tpu_torch.ops import kernels
from dwavehmc_tpu_torch.ops import tracked_eigh as tte
from dwavehmc_tpu_torch.sampler import hmc_real as thmc

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]


def _rand(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _reference_tree(x: np.ndarray) -> np.ndarray:
    """The halving tree, element by element, in numpy."""
    P = kernels.tree_length(x.shape[-1])
    v = np.zeros(x.shape[:-1] + (P,), x.dtype)
    v[..., :x.shape[-1]] = x
    while P > 1:
        P //= 2
        for i in range(P):
            v[..., i] = v[..., i] + v[..., i + P]
    return v[..., 0]


# 16562 = 2N at 91×91, past the 16384 one K3 block holds in registers
@pytest.mark.parametrize("m", [1, 7, 256, 300, 1152, 16562])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_sum_is_the_halving_tree(m, dtype):
    x = _rand((3, m), dtype)
    got = kernels.chain_sum(x)
    assert np.array_equal(got.numpy(), _reference_tree(x.numpy()))
    np.testing.assert_allclose(got.double().numpy(),
                               x.double().sum(-1).numpy(),
                               rtol=1e-5 if dtype == torch.float32 else 1e-13,
                               atol=1e-5 if dtype == torch.float32 else 1e-13)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_matvec_is_the_complex_product(dtype):
    ar, ai = _rand((2, 40, 40), dtype, 1), _rand((2, 40, 40), dtype, 2)
    vr, vi = _rand((2, 40), dtype, 3), _rand((2, 40), dtype, 4)
    wr, wi = kernels.chain_matvec_plain(ar, ai, vr, vi)
    w = (torch.complex(ar.double(), ai.double())
         @ torch.complex(vr.double(), vi.double())[..., None])[..., 0]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(wr.double().numpy(), w.real.numpy(), atol=tol)
    np.testing.assert_allclose(wi.double().numpy(), w.imag.numpy(), atol=tol)
    assert np.array_equal(wr.numpy(), _reference_tree(
        (ar * vr[:, None]).numpy()) - _reference_tree((ai * vi[:, None])
                                                       .numpy()))


def test_chain_matvec_is_the_halving_tree_at_46x46():
    """``chain_matvec_plain`` at n = 2N = 4232 (46×46), one chain, float32:
    each of the four products is the numpy halving tree over its
    zero-padded 8192 values."""
    n = 4232
    ar, ai = _rand((1, n, n), torch.float32, 1), _rand((1, n, n),
                                                       torch.float32, 2)
    vr, vi = _rand((1, n), torch.float32, 3), _rand((1, n), torch.float32, 4)
    wr, wi = kernels.chain_matvec_plain(ar, ai, vr, vi)
    a, b, u, w = (x.numpy() for x in (ar, ai, vr[:, None], vi[:, None]))
    assert np.array_equal(wr.numpy(), _reference_tree(a * u)
                          - _reference_tree(b * w))
    assert np.array_equal(wi.numpy(), _reference_tree(a * w)
                          + _reference_tree(b * u))


def _long_row_walk(x: np.ndarray, T: int, G: int) -> np.ndarray:
    """The order in which ``csrc/chain_sum.cu``'s long-row kernel adds a
    row, in numpy: thread t walks its elements x[t + T·q] in bit-reversed
    order of q, G leaves a load added as adjacent pairs, the loads' sums
    merged by a binary counter; then the halving tree over the T threads."""
    m = x.shape[-1]
    P = kernels.tree_length(m)
    lq = (P // T).bit_length() - 1
    t = np.arange(T)
    stack, s = {}, None
    for c in range((P // T) // G):
        y = [np.where(i < m, x[..., np.minimum(i, m - 1)], x.dtype.type(0))
             for i in (t + T * int(format(c * G + g, f"0{lq}b")[::-1], 2)
                       for g in range(G))]
        w = 1
        while w < G:
            y[::2 * w] = [a + b for a, b in zip(y[::2 * w], y[w::2 * w])]
            w *= 2
        s, level = y[0], 0
        while (c >> level) & 1:
            s = stack.pop(level) + s
            level += 1
        stack[level] = s
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


@pytest.mark.parametrize("m,T,G", [(16385, 512, 16), (40000, 512, 16)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_long_row_walk_is_the_halving_tree(m, T, G, dtype):
    """K3's long-row order of additions, at its (T, G) = (512, 16), is the
    halving tree bit for bit: the bit reversal pairs q with q + Q/2 first,
    as ``chain_sum_plain`` does."""
    x = _rand((2, m), torch.float64).numpy().astype(dtype) * 1e3
    assert np.array_equal(_long_row_walk(x, T, G), _reference_tree(x))


def _block_equals_batch(f, *xs, k=2):
    """f on the first k chains alone gives f's bits on the whole batch."""
    whole, alone = f(*xs), f(*(x[:k] for x in xs))
    whole = whole if isinstance(whole, tuple) else (whole,)
    alone = alone if isinstance(alone, tuple) else (alone,)
    return all(torch.equal(a[:k], b) for a, b in zip(whole, alone))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_give_a_block_the_batch_bits(dtype):
    x = _rand((6, 513), dtype)
    assert _block_equals_batch(kernels.chain_sum, x)
    ar, ai = _rand((6, 72, 72), dtype, 1), _rand((6, 72, 72), dtype, 2)
    vr, vi = _rand((6, 72), dtype, 3), _rand((6, 72), dtype, 4)
    assert _block_equals_batch(kernels.chain_matvec_plain, ar, ai, vr, vi)


def _generator(B, n, dtype, scale=0.3):
    """An anti-Hermitian S = (sr, si) per chain, σ(S) above the cap for
    ``scale`` ≳ 0.2, so the estimate's bits reach the product."""
    a, b = _rand((B, n, n), dtype, 5), _rand((B, n, n), dtype, 6)
    return (a - a.mT) * scale, (b + b.mT) * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_sweep_reductions_give_a_block_the_batch_bits(dtype):
    """The σ-cap's estimate, the Rayleigh correction and the HMC energy
    terms on a block of 2 chains alone and inside a batch of 6."""
    sr, si = _generator(6, 72, dtype)
    assert _block_equals_batch(tte._spectral_norm_est, sr, si)
    d = _rand((6, 72), dtype, 7)
    assert _block_equals_batch(tte.rayleigh_corrected_evals, sr, si, d)
    N = 36
    fields = [_rand((6, N, 2), dtype, s) for s in (8, 9, 10, 11)]
    evals = _rand((6, 2 * N), dtype, 12)
    beta = torch.linspace(1.0, 20.0, 6, dtype=dtype)

    def energy(dre, dim, pre, pim, e, b):
        return thmc._energy_terms(dre, dim, pre, pim, e, b,
                                  torch.tensor(0.8, dtype=dtype),
                                  torch.tensor(1.0, dtype=dtype))

    assert _block_equals_batch(energy, *fields, evals, beta)


def test_the_power_iteration_matches_jax():
    """σ(S) per chain against the JAX package's ``_spectral_norm_est``
    (one chain at a time), float64."""
    sr, si = _generator(3, 40, torch.float64)
    got = tte._spectral_norm_est(sr, si).numpy()
    want = [float(jte._spectral_norm_est(jnp.asarray(a.numpy()),
                                         jnp.asarray(b.numpy())))
            for a, b in zip(sr, si)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_energy_terms_match_jax():
    N = 16
    dre, dim, pre, pim = (_rand((2, N, 2), torch.float64, s)
                          for s in (1, 2, 3, 4))
    evals = _rand((2, 2 * N), torch.float64, 5)
    got = thmc._energy_terms(dre, dim, pre, pim, evals,
                             torch.tensor([5.0, 10.0], dtype=torch.float64),
                             torch.tensor(0.8, dtype=torch.float64),
                             torch.tensor(1.0, dtype=torch.float64)).numpy()
    want = [float(jhmc._energy_terms(*(jnp.asarray(x[c].numpy()) for x in (
        dre, dim, pre, pim, evals)), b, 0.8, 1.0))
        for c, b in enumerate((5.0, 10.0))]
    np.testing.assert_allclose(got, want, rtol=1e-12)
