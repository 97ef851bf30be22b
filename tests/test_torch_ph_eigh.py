"""Port parity: ``dwavehmc_tpu_torch/ops/ph_eigh.py`` against the JAX
package's PH-split eigensolver, float64 on the CPU.

Embeddings are assembled from seeded numpy draws (disorder and random Δ, so
the spectrum is non-degenerate) and handed to both packages.  Eigenvalues
agree to 1e-10; eigenvectors are compared through gauge-free quantities:
the negative-level density matrix ρ = Σ u u† (real part XXᵀ + YYᵀ)
and the HMC forces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models import bdg_real as jbdg
from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.ops import forces_real as jforces
from dwavehmc_tpu.ops import ph_eigh as jph
from dwavehmc_tpu_torch.models import bdg_real as tbdg
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import ph_eigh as tph
from dwavehmc_tpu_torch.ops.forces_real import hmc_forces_real

torch.set_num_threads(2)


def _fields(L, seed, amp=0.05, W=0.5):
    rng = np.random.default_rng(seed)
    N = L * L
    dis = rng.uniform(-W, W, (1, N))
    dre = rng.standard_normal((1, N, 2)) * amp + 0.04
    dim = rng.standard_normal((1, N, 2)) * amp
    return dis, dre, dim


def _embedding(L, seed, amp=0.05, W=0.5, tp=-0.35, mu=-1.08):
    """(1, 4N, 4N) float64 torch embedding of a random-Δ, disordered
    lattice, and its fields."""
    dis, dre, dim = _fields(L, seed, amp, W)
    p = make_params(tp=tp, mu=mu, dtype=torch.float64, device="cpu")
    lat = TLat(L, L)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    M = tbdg.assemble_embedding(
        lat, tbdg.static_embedding(lat, p.t, p.tp, p.mu, t(dis)), t(dre),
        t(dim))
    return M, (dre, dim)


def _gapless_clean(L=4):
    lat = TLat(L, L)
    N = lat.n_sites
    p = make_params(tp=0.0, mu=0.0, dtype=torch.float64, device="cpu")
    z = torch.zeros((1, N, 2), dtype=torch.float64)
    return tbdg.assemble_embedding(
        lat, tbdg.static_embedding(lat, p.t, p.tp, p.mu,
                                   torch.zeros((1, N), dtype=torch.float64)),
        z, z)


def _np(x):
    return x.detach().cpu().numpy()


def _projector(X, Y):
    """Real and imaginary parts of ρ = Σ_{E<0} u u† with U = X + iY, per
    matrix (gauge-free), stacked."""
    X, Y = np.asarray(X), np.asarray(Y)
    n = X.shape[-1] // 2
    Xn, Yn = X[..., :n], Y[..., :n]
    T = lambda a: np.swapaxes(a, -1, -2)  # noqa: E731
    return np.stack([Xn @ T(Xn) + Yn @ T(Yn), Yn @ T(Xn) - Xn @ T(Yn)])


def test_ph_map_anticommutes_exactly():
    M, _ = _embedding(6, 3)
    SMS = tph.ph_reflect(tph.ph_reflect(M.mT).mT)
    assert torch.equal(SMS, -M)
    V = torch.randn(1, M.shape[-1], 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(tph.ph_reflect(tph.ph_reflect(V)), -V)
    np.testing.assert_array_equal(_np(tph.ph_reflect(V))[0],
                                  np.asarray(jph.ph_reflect(_np(V)[0])))


@pytest.mark.parametrize("dim,dtype", [(64, torch.float32),
                                       (144, torch.float64),
                                       (2304, torch.float32)])
def test_sketch_is_bit_equal_to_jax(dim, dtype):
    got = tph._sketch(dim, dtype, torch.device("cpu"))
    want = jph._sketch(dim, str(dtype).removeprefix("torch."))
    assert got.dtype == dtype and got.shape == (dim, dim // 2)
    np.testing.assert_array_equal(_np(got), want)
    assert tph._sketch(dim, dtype, torch.device("cpu")) is got   # cached


def test_minimax_schedules_and_selection():
    for floor, table in jph._MINIMAX_BY_FLOOR.items():
        assert tph._MINIMAX_BY_FLOOR[floor] == table
    assert tph._LIFT_ABC == jph._LIFT_ABC
    assert (tph.PH_GUARD_RESID, tph.PH_GUARD_RATIO) == (
        jph.PH_GUARD_RESID, jph.PH_GUARD_RATIO)
    assert tph.minimax_schedule(1e-3) is tph._MINIMAX_1E3
    assert tph.minimax_schedule(5e-3) is tph._MINIMAX_1E3
    assert tph.minimax_schedule(2e-5) is tph._MINIMAX_1E5
    with pytest.raises(ValueError):
        tph.minimax_schedule(1e-7)
    # the lift's precision modes: on the CPU every one is the IEEE product,
    # and a name JAX does not have raises
    M = 2.0 * torch.eye(4, dtype=torch.float64)[None]
    for prec in ("default", "high"):
        assert torch.equal(tph.sign_embedding(M, lift_precision=prec),
                           tph.sign_embedding(M))
    with pytest.raises(ValueError):
        tph.sign_embedding(M, lift_precision="fast")


@pytest.mark.parametrize("L,orth", [(4, "chol"), (6, "chol"), (4, "ns"),
                                    (6, "ns")])
def test_diagonalize_embedding_ph_matches_jax(L, orth):
    M, (dre, dim) = _embedding(L, 10 + L)
    w, X, Y = tph.diagonalize_embedding_ph(M, orth=orth)
    jw, jX, jY = jph.diagonalize_embedding_ph(jnp.asarray(_np(M)[0]),
                                              orth=orth)
    np.testing.assert_allclose(_np(w)[0], np.asarray(jw), atol=1e-10)
    np.testing.assert_allclose(_projector(_np(X)[0], _np(Y)[0]),
                               _projector(jX, jY), atol=1e-10)
    # and the oracle, one eigenvalue per doubled level (the matmul-only
    # orthonormalization stops short of the float64 floor)
    np.testing.assert_allclose(_np(w)[0], np.linalg.eigvalsh(_np(M)[0])[::2],
                               atol=1e-9 if orth == "chol" else 1e-5)
    # forces from either package's eigenpairs, each in its own package
    lat, beta, J = TLat(L, L), 10.0, 1.0
    tF = hmc_forces_real(lat, torch.as_tensor(dre), torch.as_tensor(dim),
                         w, X, Y, torch.tensor(beta, dtype=torch.float64),
                         torch.tensor(J, dtype=torch.float64))
    jF = jforces.hmc_forces_real(JLat(L, L), jnp.asarray(dre[0]),
                                 jnp.asarray(dim[0]), jw, jX, jY, beta, J)
    for a, b in zip(tF[:2], jF[:2]):
        np.testing.assert_allclose(_np(a)[0], np.asarray(b), atol=1e-10)


def test_batched_solve_matches_single():
    M = torch.cat([_embedding(4, 21)[0], _embedding(4, 22)[0]])
    wb, Xb, _ = tph.diagonalize_embedding_ph(M)
    for i in range(2):
        w, X, _ = tph.diagonalize_embedding_ph(M[i:i + 1])
        np.testing.assert_allclose(_np(wb[i]), _np(w[0]), atol=1e-12)
        np.testing.assert_allclose(_np(Xb[i]), _np(X[0]), atol=1e-10)


def _guarded_both(M):
    tph.reset_guard()
    t = tph.diagonalize_embedding_ph_guarded(M)
    j = jph.diagonalize_embedding_ph_guarded(jnp.asarray(_np(M)))
    return t, j


def test_guarded_uses_ph_on_healthy_spectrum():
    M, _ = _embedding(6, 2, amp=0.02)
    (w, X, Y, fb), (jw, jX, jY, jfb) = _guarded_both(M)
    assert fb is False and not bool(jfb)
    assert tph.GUARD == {"solves": 1, "fallbacks": 0, "resid_failed": 0,
                         "ratio_failed": 0, "nonfinite": 0, "rescued": 0,
                         "redone": 0}
    w_ph, X_ph, _ = tph.diagonalize_embedding_ph(M)
    assert torch.equal(w, w_ph) and torch.equal(X, X_ph)
    np.testing.assert_allclose(_np(w), np.asarray(jw), atol=1e-10)
    np.testing.assert_allclose(_projector(_np(X), _np(Y)),
                               _projector(jX, jY), atol=1e-10)


@pytest.mark.parametrize("mixed", [False, True])
def test_guarded_falls_back_on_gapless_spectrum(mixed):
    """A gapless chain sends the whole batch to the full eigh, on both
    sides; the port's result is its own ``diagonalize_embedding``."""
    M = _gapless_clean(4)
    if mixed:
        M = torch.cat([_embedding(4, 2)[0], M])
    (w, X, Y, fb), (jw, _, _, jfb) = _guarded_both(M)
    assert fb is True and bool(jfb)
    assert (tph.GUARD["solves"], tph.GUARD["fallbacks"]) == (1, 1)
    # only the gapless chain fails, by its Ritz value at zero
    assert tph.GUARD["ratio_failed"] == 1 and tph.GUARD["nonfinite"] == 0
    assert tph.GUARD["resid_failed"] <= 1
    w0, X0, Y0 = tbdg.diagonalize_embedding(M)
    assert torch.equal(w, w0) and torch.equal(X, X0) and torch.equal(Y, Y0)
    np.testing.assert_allclose(_np(w), np.asarray(jw), atol=1e-10)


def test_guarded_nonfinite_input_is_zeroed_as_in_jax():
    M, _ = _embedding(4, 5)
    M[0, 0, 0] = float("nan")
    (w, X, Y, fb), (jw, jX, jY, jfb) = _guarded_both(M)
    assert fb == bool(jfb)
    assert bool(torch.isfinite(w).all() & torch.isfinite(X).all())
    np.testing.assert_allclose(_np(w), np.asarray(jw), atol=1e-10)
    w_un, _, _ = tph.diagonalize_embedding_ph(M)          # unguarded: no crash
    assert w_un.shape == (1, M.shape[-1] // 2)


def test_failed_cholesky_gives_nan_like_jax():
    G = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]],
                     dtype=torch.float64)
    L = tph._cholesky_nan(G)
    np.testing.assert_array_equal(_np(L[0]),
                                  np.asarray(jnp.linalg.cholesky(_np(G)[0])))
    np.testing.assert_allclose(_np(L[1]), np.linalg.cholesky(_np(G[1])))
