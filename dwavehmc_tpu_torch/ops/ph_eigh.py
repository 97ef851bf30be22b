"""Particle-hole–split exact eigensolver for the BdG real embedding (port of
``dwavehmc_tpu/ops/ph_eigh.py``).

The BdG Hamiltonian has a particle–hole symmetry that, on the real
embedding M = [[A, −B], [B, A]], is the LINEAR signed permutation

    S : [x₁, x₂, y₁, y₂]  →  [x₂, −x₁, −y₂, y₁]        (S Mᵀ S = −M).

So the spectrum is symmetric about 0, the positive subspace has rank
exactly dim/2, and every negative eigenvector is S applied to a positive
one.  The exact diagonalization reduces to

 1. sign(M) by a matmul-only polynomial iteration (an interval-minimax
    quintic schedule, then cubic Newton–Schulz),
 2. an orthonormal basis Q of the positive subspace from a fixed random
    sketch of P₊ = (I + sign M)/2 (shifted CholeskyQR³),
 3. Rayleigh–Ritz: eigh of T = Qᵀ M Q at HALF the dimension, V₊ = Q V_T,
 4. the negative half exactly by applying S.

Every product is an IEEE float32 (or float64) ``torch.matmul``: the
package switches TF32 off, and the minimax composition needs full-precision
products to stay in its basin (see the schedule tables).  The one exception
is the lift loop at ``lift_precision`` "high" (three TF32 products per
product) or "default" (one) on the card (``utils/precision``); the
Newton–Schulz clean-up after it stays IEEE, so the converged sign reaches
the float32 floor.  One TF32 pass loses the sign of the levels near zero,
and the floor guard does not see it: "default" is not for production
spectra.  The half-dimension eigh goes through
``models/bdg_real.symmetric_eigh``, so on the card it avoids the inaccurate
float32 Jacobi solver at dimension ≤ 512.

``diagonalize_embedding_ph_guarded`` checks convergence and re-solves the
whole batch with ``models/bdg_real.diagonalize_embedding`` when any chain
fails: one host-side branch on one ``bool``, i.e. one device sync per call.
That fallback is the JAX package's own semantics (its batch-level
``lax.cond``); it is counted in ``GUARD``.  Under a process group the batch
is the ensemble of every rank, so the ``bool`` is an all-reduce over ranks
(``parallel/mesh.any_across_ranks``).

Before that decision the guard rescues each chain whose float32 CholeskyQR³
broke down (a non-finite positive basis), which the JAX package sends to
the fallback with its whole batch.  The sketch Y = P₊G has a square
Gaussian core, whose κ has a heavy tail; at κ(Y) ≳ 1e5 float32 loses the
weak directions of span(Y), and the factorization fails.  Only those chains
are redone, in float64 (``_ritz_float64``: the float32 sign matrix refined
by Newton–Schulz steps, the sketch, CholeskyQR³ and the Rayleigh–Ritz
step), and counted in ``GUARD["rescued"]``.  A chain that does not break
down takes exactly the JAX algorithm's operations; the rescue's syncs run
only when a chain broke down.

A diverged chain (levels of ~1e35, finite, so the zeroing of non-finite
entries keeps them) fails the guard, and the fallback's float32 ``eigh``
may then not converge on the card.  ``symmetric_eigh`` then solves the
batch chain by chain and redoes in float64 only the chains that fail alone
(``GUARD["redone"]``, each solve a host read under
``dwavehmc.sync.fallback_redo``), so the solve returns, as the JAX
package's QDWH eigh does, and the Metropolis step rejects the chain on its
ΔH.  A fallback whose ``eigh`` converges takes the one call it took.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.bdg_real import diagonalize_embedding, symmetric_eigh
from ..parallel.mesh import any_across_ranks
from ..utils.precision import matmul_precision, product
from ..utils.profiling import sync_span

#: since the last ``reset_guard()``: guarded solves, their fallbacks, and
#: over the fallbacks this process's voting chains that failed the guard —
#: by an unconverged sign iteration, by a Ritz value under the floor, by a
#: non-finite one; and, over all solves, this process's voting chains whose
#: float32 CholeskyQR³ broke down and were redone in float64 (``rescued``);
#: and the chains whose float32 ``eigh`` (the fallback's, or the Ritz
#: step's) did not converge and were redone in float64 (``redone``)
GUARD = {"solves": 0, "fallbacks": 0, "resid_failed": 0, "ratio_failed": 0,
         "nonfinite": 0, "rescued": 0, "redone": 0}

#: Newton–Schulz steps that refine a float32 sign matrix in float64 before a
#: rescued chain's sketch (the error squares each step: 1e-6 → 1e-12)
RESCUE_NS_STEPS = 2

#: quintic lift coefficients p(x) = a·x + b·x³ + c·x⁵: multiplies small
#: singular values by ~3.44 per application while keeping p([0, 1.02])
#: inside [0, ~1.2] (the fixed-coefficient fallback schedule)
_LIFT_ABC = (3.4445, -4.7750, 2.0315)

#: interval-minimax quintic schedule for |E|min/‖M‖ ≥ 1e-5: step k is the
#: Remez-optimal odd quintic on the image interval of step k−1, optimized
#: on [l, 1.05·u]; the 5% margin keeps the composition inside the
#: contraction basin when matmuls add noise.  10 steps map [1e-5, 1] into
#: [1∓6e-5].
_MINIMAX_1E5 = (
    (8.108458, -21.837891, 14.703751),
    (4.053782, -2.729520, 0.459486),
    (4.051804, -2.728312, 0.459370),
    (4.043810, -2.723430, 0.458899),
    (4.011801, -2.703853, 0.457013),
    (3.888355, -2.627951, 0.449713),
    (3.475152, -2.368622, 0.424954),
    (2.595839, -1.776606, 0.370504),
    (1.923282, -1.243587, 0.330214),
    (1.830378, -1.161187, 0.330860),
)

#: shallower schedules (same construction) for better-conditioned spectra;
#: a spectrum below the stated floor diverges under composition
_MINIMAX_1E3 = (
    (8.068965, -21.696409, 14.601655),
    (3.990873, -2.691030, 0.455779),
    (3.811545, -2.580386, 0.445149),
    (3.260846, -2.230295, 0.411904),
    (2.331140, -1.580238, 0.353808),
    (1.861979, -1.187915, 0.328541),
)

_MINIMAX_1E4 = (
    (8.104853, -21.824973, 14.694429),
    (4.047961, -2.725965, 0.459144),
    (4.028361, -2.713987, 0.457990),
    (3.951296, -2.666732, 0.453441),
    (3.674171, -2.494620, 0.436943),
    (2.942654, -2.018669, 0.392256),
    (2.077411, -1.377361, 0.338267),
    (1.835356, -1.164485, 0.329544),
)

_MINIMAX_BY_FLOOR = {1e-3: _MINIMAX_1E3, 1e-4: _MINIMAX_1E4,
                     1e-5: _MINIMAX_1E5}

#: guard thresholds: a converged sign matrix has ‖X²−I‖max at the float32
#: floor, an eigenvalue left unconverged below the schedule floor gives O(1);
#: the smallest Ritz value over ‖M‖∞ must clear the floor with a 2× margin
PH_GUARD_RESID = 0.05
PH_GUARD_RATIO = 2e-5


def reset_guard() -> None:
    for name in GUARD:
        GUARD[name] = 0


def minimax_schedule(floor: float):
    """The shallowest embedded minimax schedule valid for a given spectral
    floor |E|min/‖M‖ (≥ the requested floor)."""
    for f in sorted(_MINIMAX_BY_FLOOR, reverse=True):
        if floor >= f:
            return _MINIMAX_BY_FLOOR[f]
    raise ValueError(
        f"no embedded schedule for spectral floor {floor:g} (< 1e-5); "
        "regenerate via the Remez snippet in docs/design.md")


def ph_reflect(V: torch.Tensor) -> torch.Tensor:
    """Apply the PH map S to eigenvector columns: (…, 4N, k) → (…, 4N, k).

    Row blocks [x₁, x₂, y₁, y₂] (each N) → [x₂, −x₁, −y₂, y₁]; maps an
    E-eigenvector of the embedding to a (−E)-eigenvector exactly."""
    x1, x2, y1, y2 = torch.chunk(V, 4, dim=-2)
    return torch.cat([x2, -x1, -y2, y1], dim=-2)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def sign_embedding(M: torch.Tensor, n_lift: int | None = None, n_ns: int = 3,
                   lift_precision: str = "highest", floor: float = 1e-5,
                   return_resid: bool = False):
    """Matrix sign function of symmetric M (…, d, d) with spectrum bounded
    away from 0, by scaled polynomial iteration (matmuls only).

    ``n_lift=None`` uses the minimax schedule for ``floor``; an integer
    selects that many fixed-coefficient lift steps.  ``n_ns`` Newton–Schulz
    steps follow.  ``lift_precision`` ("default", "high", "highest") sets
    the lift loop's products only (``utils/precision``); the Newton–Schulz
    steps stay IEEE.  ``return_resid`` also returns
    ‖X²−I‖max of the last pre-update iterate per matrix, the guard's
    convergence test."""
    # ‖M‖₂ ≤ ‖M‖∞ (row sum): a guaranteed bound, so the quintic cannot
    # diverge on an underestimate
    lam = M.abs().sum(-1).amax(-1)[..., None, None]
    X = M / lam
    sched = (minimax_schedule(floor) if n_lift is None
             else (_LIFT_ABC,) * n_lift)
    mm = product(lift_precision)
    with matmul_precision(lift_precision, M.device):
        for a, b, c in sched:
            X2 = mm(X, X)
            X = a * X + mm(X2, b * X + c * mm(X2, X))
    X2 = None
    for _ in range(n_ns):
        X2 = X @ X
        X = 1.5 * X - 0.5 * (X2 @ X)
    if not return_resid:
        return X
    if X2 is None:
        X2 = X @ X
    resid = (X2 - _eye(X.shape[-1], X)).abs().amax(dim=(-2, -1))
    return X, resid


@functools.lru_cache(maxsize=8)
def _sketch_np(dim: int, dtype_name: str) -> np.ndarray:
    """Fixed random (dim, dim/2) sketch, bit-identical to the JAX
    package's: ``default_rng(0x9E3779B9 ^ dim)`` standard normals."""
    rng = np.random.default_rng(0x9E3779B9 ^ dim)
    return rng.standard_normal((dim, dim // 2)).astype(dtype_name)


@functools.lru_cache(maxsize=8)
def _sketch(dim: int, dtype: torch.dtype, device: torch.device
            ) -> torch.Tensor:
    """The sketch on ``device``, copied there once per (dim, dtype,
    device): an anchor reuses it rather than copying ~10 MB from pageable
    host memory each time."""
    name = str(dtype).removeprefix("torch.")
    return torch.from_numpy(_sketch_np(dim, name)).to(device)


def _cholesky_nan(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a matrix whose factorization fails gets NaN
    on and below the diagonal, as JAX's ``cholesky`` returns it
    (``torch.linalg.cholesky`` would raise)."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where((info != 0)[..., None, None],
                       torch.tril(torch.full_like(L, float("nan"))), L)


def cholqr2(Y: torch.Tensor, shift_first: bool = True) -> torch.Tensor:
    """Shifted CholeskyQR³ orthonormalization of the columns of Y
    (…, d, k): a first pass on the shifted Gram matrix (guarantees the
    factorization and bounds the intermediate κ), then two unshifted
    passes to the floating-point floor."""
    n = Y.shape[-2]
    passes = 3 if shift_first else 2
    for i in range(passes):
        G = Y.mT @ Y
        if shift_first and i == 0:
            eps = torch.finfo(Y.dtype).eps
            s = 11.0 * n * eps * G.abs().sum(-1).amax(-1)
            G = G + s[..., None, None] * _eye(G.shape[-1], G)
        L = _cholesky_nan(G)
        # Y ← Y L⁻ᵀ
        Y = torch.linalg.solve_triangular(L.mT, Y, upper=True, left=False)
    return Y


def orth_ns(Y: torch.Tensor, n_lift: int = 8, n_ns: int = 4) -> torch.Tensor:
    """Matmul-only orthonormalization (rectangular quintic + Newton–Schulz
    polar iteration); handles κ(Y) up to ~3.44^n_lift."""
    g = (Y.mT @ Y).abs().sum(-1).amax(-1)[..., None, None]
    X = Y / torch.sqrt(g)
    a, b, c = _LIFT_ABC
    for _ in range(n_lift):
        G = X.mT @ X
        X = a * X + X @ (b * G + c * (G @ G))
    for _ in range(n_ns):
        G = X.mT @ X
        X = 1.5 * X - 0.5 * (X @ G)
    return X


def _sketched(M: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """Y = P₊G = (sgn·G + G)/2 for the fixed sketch G (…, 4N, 2N)."""
    G = _sketch(M.shape[-1], M.dtype, M.device)
    return 0.5 * (sgn @ G + G)


def positive_basis(M: torch.Tensor, sgn: torch.Tensor,
                   orth: str = "chol") -> torch.Tensor:
    """Orthonormal basis (…, 4N, 2N) of the positive-energy subspace from
    the (approximate) sign matrix."""
    Y = _sketched(M, sgn)
    return cholqr2(Y) if orth == "chol" else orth_ns(Y)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _ritz(M: torch.Tensor, Q: torch.Tensor):
    """Rayleigh–Ritz on span(Q): ascending Ritz values wt (…, 2N) and
    vectors Vp = Q·V_T (…, 4N, 2N).  T is symmetrized and NaN-masked
    before its eigh."""
    T = Q.mT @ (M @ Q)
    T = _finite_or_zero(0.5 * (T + T.mT))
    wt, Vt = symmetric_eigh(T, GUARD)
    return wt, Q @ Vt


def _ritz_float64(M: torch.Tensor, sgn: torch.Tensor):
    """``_ritz`` on the positive basis, recomputed in float64 from the
    sign matrix ``sgn`` refined by ``RESCUE_NS_STEPS`` Newton–Schulz
    steps, cast back to M's dtype: the rescue of chains whose float32
    CholeskyQR³ broke down."""
    s = sgn.double()
    for _ in range(RESCUE_NS_STEPS):
        s = 1.5 * s - 0.5 * ((s @ s) @ s)
    M64 = M.double()
    wt, Vp = _ritz(M64, cholqr2(_sketched(M64, s)))
    return wt.to(M.dtype), Vp.to(M.dtype)


def _split_levels(wt: torch.Tensor, Vp: torch.Tensor):
    """(evals, X, Y) from the positive Ritz pairs: one representative per
    doubled level, the negative half by the PH map, ascending."""
    half = Vp.shape[-2] // 2
    wp = wt[..., ::2]
    Vp1 = Vp[..., :, ::2]
    Vn1 = ph_reflect(Vp1).flip(-1)                   # (−E)-vectors, ascending
    evals = torch.cat([-wp.flip(-1), wp], dim=-1)
    V = torch.cat([Vn1, Vp1], dim=-1)
    return (evals.contiguous(), V[..., :half, :].contiguous(),
            V[..., half:, :].contiguous())


def diagonalize_embedding_ph_guarded(M: torch.Tensor, *, floor: float = 1e-5,
                                     lift_precision: str = "highest",
                                     orth: str = "chol", vote=None):
    """PH-split diagonalization of a batch with a floor guard.

    First redoes in float64 (``_ritz_float64``) each voting chain whose
    positive basis came out non-finite (a CholeskyQR³ breakdown).  Then
    falls back to ``diagonalize_embedding`` for the WHOLE batch when any
    matrix (a) left the sign iteration unconverged (‖sgn²−I‖max >
    PH_GUARD_RESID: a spectrum below the schedule's floor) or (b) has its
    smallest Ritz value under PH_GUARD_RATIO·‖M‖∞, or (c) gave a non-finite
    Ritz value.  Only the branch taken is computed.  Non-finite entries of
    M are zeroed first.  Returns ``(evals, X, Y, used_fallback)`` with
    ``used_fallback`` a Python bool.

    Under a process group the decision is the any over every rank's chains,
    so all ranks fall back together, as the JAX package's ``lax.cond`` does
    over its global batch: every rank must make the same sequence of
    guarded calls.  ``vote`` (B,) bool marks the chains whose failure
    counts (None: all); a rank's padded copies and stand-in batches vote
    False."""
    Mg = _finite_or_zero(M)
    sgn, resid = sign_embedding(Mg, lift_precision=lift_precision,
                                floor=floor, return_resid=True)
    Q = positive_basis(Mg, sgn, orth=orth)
    broken = ~torch.isfinite(Q).flatten(-2).all(-1)
    wt, Vp = _ritz(Mg, Q)
    del Q
    lam = Mg.abs().sum(-1).amax(-1)
    votes = None if vote is None else torch.as_tensor(vote,
                                                      device=wt.device)

    def guard_fails():
        min_ratio = wt.abs().amin(-1) / torch.clamp(lam, min=1e-30)
        f = torch.stack([~(resid < PH_GUARD_RESID),
                         ~(min_ratio > PH_GUARD_RATIO),
                         ~torch.isfinite(wt).all(-1)])
        return f if votes is None else f & votes

    fails = guard_fails()
    if votes is not None:
        broken = broken & votes
    GUARD["solves"] += 1
    # a healthy solve's one host read: any failure, any breakdown
    with sync_span("ph_guard"):
        failing, rescue = torch.stack([fails.any(), broken.any()]).tolist()
    if rescue:
        with sync_span("ph_rescue_rows"):
            k = torch.nonzero(broken)[:, 0]
        wt[k], Vp[k] = _ritz_float64(Mg[k], sgn[k])
        GUARD["rescued"] += len(k)
        fails = guard_fails()
        with sync_span("ph_rescue_guard"):
            failing = bool(fails.any())
    if not any_across_ranks(failing):
        return (*_split_levels(wt, Vp), False)
    GUARD["fallbacks"] += 1
    with sync_span("ph_fallback_counts"):
        counts = fails.sum(-1).tolist()
    for name, n in zip(("resid_failed", "ratio_failed", "nonfinite"),
                       counts):
        GUARD[name] += n
    return (*diagonalize_embedding(Mg, GUARD), True)


def diagonalize_embedding_ph(M: torch.Tensor, n_lift: int | None = None,
                             n_ns: int = 3, orth: str = "chol",
                             lift_precision: str = "highest",
                             floor: float = 1e-5):
    """Drop-in for ``models/bdg_real.diagonalize_embedding``: (evals
    (…, 2N), X (…, 2N, 2N), Y (…, 2N, 2N)), one eigenpair per doubled
    level, ascending, complex eigenvectors U = X + iY.  Unguarded: the
    caller must know the spectrum clears ``floor``."""
    sgn = sign_embedding(M, n_lift=n_lift, n_ns=n_ns,
                         lift_precision=lift_precision, floor=floor)
    return _split_levels(*_ritz(M, positive_basis(M, sgn, orth=orth)))
