"""Port parity for ``tracked_eigh`` with its exact fallback and for
``full_eigh_from_parts``, float64 on the CPU: mirrors of
``tests/test_tracked_eigh.py`` (exact from parts, a warm start converges
without the fallback, a cold start takes it) held chain by chain against
the JAX package's per-matrix ``tracked_eigh``.  The states are disordered
with random Δ, so no level is degenerate (ROADMAP fault F0) and the
projectors u_k u_k† are gauge-invariant.  Tolerance 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.bdg import assemble_bdg, static_hamiltonian
from dwavehmc_tpu.models.lattice import LatticeSpec
from dwavehmc_tpu.ops import tracked_eigh as jte
from dwavehmc_tpu_torch.ops import tracked_eigh as tte

torch.set_num_threads(2)

LAT = LatticeSpec(4, 4)
TOL = dict(rtol=1e-10, atol=1e-10)


def random_H(seed, amp=0.3):
    """The JAX test's H: disorder U[0, 0.5), Δ complex normal · amp."""
    rng = np.random.default_rng(seed)
    disorder = jnp.asarray(rng.uniform(0, 0.5, LAT.n_sites))
    delta = jnp.asarray(amp * (rng.normal(size=(LAT.n_sites, 2))
                               + 1j * rng.normal(size=(LAT.n_sites, 2))))
    Hs = static_hamiltonian(LAT, 1.0, -0.35, -1.08, disorder)
    return np.asarray(assemble_bdg(LAT, Hs, delta))


def nudged(H, seed, eps=0.01):
    rng = np.random.default_rng(seed)
    dP = eps * (rng.normal(size=H.shape) + 1j * rng.normal(size=H.shape))
    return H + dP + dP.conj().T


def random_unitary(seed, n):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return Q


def projectors(Ur, Ui):
    U = np.asarray(Ur) + 1j * np.asarray(Ui)
    return np.einsum("ik,jk->kij", U, U.conj())


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy()


def run_both(Hs, U0s, **kw):
    """(JAX per matrix, port batched) ``tracked_eigh`` results as numpy."""
    want = [jte.tracked_eigh(jnp.asarray(H.real), jnp.asarray(H.imag),
                             jnp.asarray(U.real), jnp.asarray(U.imag), **kw)
            for H, U in zip(Hs, U0s)]
    H, U = np.stack(Hs), np.stack(U0s)
    got = tte.tracked_eigh(_t(H.real), _t(H.imag), _t(U.real), _t(U.imag),
                           **kw)
    return want, [_np(x) for x in got]


def test_full_eigh_from_parts_exact():
    Hs = np.stack([random_H(0), random_H(7)])
    e, Ur, Ui = (_np(x) for x in tte.full_eigh_from_parts(_t(Hs.real),
                                                           _t(Hs.imag)))
    for c, H in enumerate(Hs):
        U = Ur[c] + 1j * Ui[c]
        np.testing.assert_allclose(H @ U, U * e[c][None, :], atol=1e-9)
        je, jur, jui = jte.full_eigh_from_parts(jnp.asarray(H.real),
                                                jnp.asarray(H.imag))
        np.testing.assert_allclose(e[c], np.asarray(je), **TOL)
        np.testing.assert_allclose(projectors(Ur[c], Ui[c]),
                                   projectors(jur, jui), **TOL)
        assert np.diff(e[c]).min() > 1e-6      # non-degenerate (F0)


def test_warm_start_converges_and_matches():
    """H nudged away from its exact eigenbasis: the tracked solve from that
    basis takes no fallback and agrees with JAX's and with the exact eigh."""
    Hs0 = [random_H(1), random_H(11)]
    U0s = []
    for H in Hs0:
        _, ur, ui = jte.full_eigh_from_parts(jnp.asarray(H.real),
                                             jnp.asarray(H.imag))
        U0s.append(np.asarray(ur) + 1j * np.asarray(ui))
    Hs = [nudged(H, 2 + c) for c, H in enumerate(Hs0)]
    want, (e, Ur, Ui, bad) = run_both(Hs, U0s, n_iter=14, tol=1e-6)
    assert bad.dtype == np.bool_ and not bad.any()
    for c, (je, jur, jui, jbad) in enumerate(want):
        assert not bool(jbad)
        np.testing.assert_allclose(e[c], np.asarray(je), **TOL)
        np.testing.assert_allclose(projectors(Ur[c], Ui[c]),
                                   projectors(jur, jui), **TOL)
        e_exact, _, _ = jte.full_eigh_from_parts(jnp.asarray(Hs[c].real),
                                                 jnp.asarray(Hs[c].imag))
        np.testing.assert_allclose(e[c], np.asarray(e_exact), atol=1e-7)
        U = Ur[c] + 1j * Ui[c]
        np.testing.assert_allclose(U.conj().T @ U, np.eye(U.shape[0]),
                                   atol=1e-7)


def test_cold_start_takes_fallback_per_chain(monkeypatch):
    """A batch of a cold chain (random basis) between two warm ones: only
    the cold chain falls back, as JAX decides matrix by matrix, and every
    chain gets JAX's spectrum and projectors.  The n_iter rotations are one
    K1 call each for the whole batch."""
    calls = []
    rot = tte.rotation_s_parts
    monkeypatch.setattr(tte, "rotation_s_parts",
                        lambda *a: calls.append(1) or rot(*a))
    Hs, U0s = [], []
    for c, seed in enumerate((5, 3, 9)):
        H = random_H(seed)
        if c == 1:
            U0s.append(random_unitary(4, H.shape[0]))
        else:
            _, ur, ui = jte.full_eigh_from_parts(jnp.asarray(H.real),
                                                 jnp.asarray(H.imag))
            U0s.append(np.asarray(ur) + 1j * np.asarray(ui))
            H = nudged(H, seed, eps=1e-3)
        Hs.append(H)
    want, (e, Ur, Ui, bad) = run_both(Hs, U0s, n_iter=2, tol=1e-4)
    assert len(calls) == 2
    assert list(bad) == [bool(w[3]) for w in want] == [False, True, False]
    for c, (je, jur, jui, _) in enumerate(want):
        np.testing.assert_allclose(e[c], np.asarray(je), **TOL)
        np.testing.assert_allclose(projectors(Ur[c], Ui[c]),
                                   projectors(jur, jui), **TOL)
        assert np.all(np.diff(e[c]) >= 0)


@pytest.mark.parametrize("bad_value", [np.nan, np.inf])
def test_non_finite_entries_are_zeroed_for_the_eigh(bad_value):
    """``torch.linalg.eigh`` raises on NaN: a non-finite entry is zeroed in
    the matrix handed to it, as the complex leapfrog does."""
    H = random_H(6)
    hr, hi = H.real.copy(), H.imag.copy()
    hr[3, 5] = bad_value
    got = tte.full_eigh_from_parts(_t(hr[None]), _t(hi[None]))
    hr[3, 5] = 0.0
    want = tte.full_eigh_from_parts(_t(hr[None]), _t(hi[None]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
