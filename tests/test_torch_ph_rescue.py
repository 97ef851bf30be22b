"""The PH anchor's rescue of a CholeskyQR³ breakdown (ROADMAP fault F5), on
the CPU.

The guard redoes a chain whose float32 positive basis came out non-finite
in float64 (``ops/ph_eigh._ritz_float64``: the sign matrix refined by
Newton–Schulz steps, the sketch, CholeskyQR³ and the Rayleigh–Ritz step),
rather than sending the whole batch to the full ``eigh``; the other chains
keep the JAX algorithm's operations and bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.ops import ph_eigh as jph
from dwavehmc_tpu_torch.models import bdg_real as tbdg
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import ph_eigh as tph

torch.set_num_threads(2)


def _broken_batch(k=8, d=64, seed=5):
    """(3, d, k) float32: chains 0 and 2 Gaussian; chain 1's first two
    columns are all ones but for one entry 1 + 2⁻²², so its float32 Gram
    matrix rounds to an exactly singular 2×2 block (every entry 64) while
    the float64 one stays positive definite."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((3, d, k)).astype(np.float32)
    Y[1, :, :2] = 1.0
    Y[1, 0, 1] = np.float32(1.0 + 2.0**-22)
    return torch.from_numpy(Y)


def test_a_breakdown_leaves_the_chain_nan_as_in_jax():
    """An unshifted pass of float32 CholeskyQR³ fails on the constructed
    chain: the port's chain is NaN, as the JAX package's is, the float64
    passes succeed, and the healthy chains agree with JAX's."""
    Y = _broken_batch()
    assert torch.equal((Y.mT @ Y)[1, :2, :2], torch.full((2, 2), 64.0))
    Q = tph.cholqr2(Y, shift_first=False)
    jQ = np.asarray(jph.cholqr2(jnp.asarray(Y.numpy()), shift_first=False))
    assert not bool(torch.isfinite(Q[1]).any())
    assert not np.isfinite(jQ[1]).any()
    np.testing.assert_allclose(Q[[0, 2]].numpy(), jQ[[0, 2]], atol=2e-5)
    assert bool(torch.isfinite(tph.cholqr2(Y.double(),
                                           shift_first=False)).all())


def _embeddings(L=4, B=3, seed=11):
    """(B, 4N, 4N) float32 embeddings of random-Δ, disordered lattices."""
    rng = np.random.default_rng(seed)
    lat = LatticeSpec(L, L)
    N = lat.n_sites
    p = make_params(tp=-0.35, mu=-1.08, dtype=torch.float32, device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    dis = t(rng.uniform(-0.5, 0.5, (B, N)))
    dre = t(rng.standard_normal((B, N, 2)) * 0.05 + 0.04)
    dim = t(rng.standard_normal((B, N, 2)) * 0.05)
    return tbdg.assemble_embedding(
        lat, tbdg.static_embedding(lat, p.t, p.tp, p.mu, dis), dre, dim)


def _break_chain(monkeypatch, chain: int):
    """Make chain ``chain``'s float32 CholeskyQR³ break down (NaN), as it
    breaks down on the card; float64 calls are left alone."""
    real = tph.cholqr2

    def failing(Y, shift_first=True):
        Q = real(Y, shift_first)
        if Y.dtype == torch.float32 and Y.shape[0] > chain:
            Q = Q.clone()
            Q[chain] = float("nan")
        return Q

    monkeypatch.setattr(tph, "cholqr2", failing)


def test_guard_rescues_a_broken_chain_without_falling_back(monkeypatch):
    M = _embeddings()
    w_ref, X_ref, Y_ref = tph.diagonalize_embedding_ph(M)
    tph.reset_guard()
    _break_chain(monkeypatch, 1)
    w, X, Y, fb = tph.diagonalize_embedding_ph_guarded(M)
    assert fb is False
    assert (tph.GUARD["solves"], tph.GUARD["fallbacks"],
            tph.GUARD["rescued"]) == (1, 0, 1)
    for a, b in ((w, w_ref), (X, X_ref), (Y, Y_ref)):
        assert torch.equal(a[[0, 2]], b[[0, 2]])
    w64 = torch.linalg.eigvalsh(M.double())[..., ::2]
    err = (w.double() - w64).abs().amax(-1)
    assert float(err[1]) <= float(err[[0, 2]].max())
    eye = torch.eye(X.shape[-1], dtype=torch.float64)
    X1, Y1 = X[1].double(), Y[1].double()
    assert float((X1.mT @ X1 + Y1.mT @ Y1 - eye).abs().max()) <= 1e-5


def test_a_non_voting_chain_is_neither_rescued_nor_counted(monkeypatch):
    M = _embeddings()
    tph.reset_guard()
    _break_chain(monkeypatch, 1)
    _, _, _, fb = tph.diagonalize_embedding_ph_guarded(
        M, vote=torch.tensor([True, False, True]))
    assert fb is False
    assert (tph.GUARD["fallbacks"], tph.GUARD["rescued"]) == (0, 0)


def _ill_conditioned_sketch(monkeypatch, d):
    """Two sketch columns 1e-6 apart: κ(P₊G) ≈ 1e6, beyond float32."""
    G = torch.from_numpy(tph._sketch_np(d, "float64")).clone()
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(d))
    G[:, 1] = G[:, 0] + 1e-6 * z
    monkeypatch.setattr(tph, "_sketch", lambda dim, dtype, device: G.to(
        device, dtype))


def test_float64_rescue_recovers_an_ill_conditioned_sketch(monkeypatch):
    """The float32 Ritz values of an ill-conditioned sketch are far off (or
    NaN); the float64 rescue's are at float32 rounding."""
    M = _embeddings(B=2)
    d = M.shape[-1]
    _ill_conditioned_sketch(monkeypatch, d)
    sgn = tph.sign_embedding(M)
    w64 = torch.linalg.eigvalsh(M.double())[..., d // 2:]
    norm = float(M.abs().sum(-1).amax())
    wt32, _ = tph._ritz(M, tph.positive_basis(M, sgn))
    wt, Vp = tph._ritz_float64(M, sgn)
    assert wt.dtype == Vp.dtype == torch.float32
    err = float((wt.double() - w64).abs().max()) / norm
    err32 = (wt32.double() - w64).abs().max() / norm
    assert err <= 1e-6
    assert not bool(torch.isfinite(err32)) or float(err32) > 100 * err


def test_guard_rescues_the_chains_of_an_ill_conditioned_sketch(monkeypatch):
    """Every chain's float32 CholeskyQR³ breaks down on its own: all are
    rescued, none falls back, and the levels match float64 ``eigvalsh``."""
    M = _embeddings()
    _ill_conditioned_sketch(monkeypatch, M.shape[-1])
    tph.reset_guard()
    w, _, _, fb = tph.diagonalize_embedding_ph_guarded(M)
    assert fb is False
    assert (tph.GUARD["fallbacks"], tph.GUARD["rescued"]) == (0, 3)
    w64 = torch.linalg.eigvalsh(M.double())[..., ::2]
    assert float((w.double() - w64).abs().max()) <= 1e-6 * float(
        M.abs().sum(-1).amax())
