"""Tracked (warm-started) Hermitian eigensolver for the leapfrog hot loop.

Port of ``dwavehmc_tpu/ops/tracked_eigh.py`` over a leading chain
dimension.  Inside one leapfrog step H changes by O(dt), so the previous
step's eigenbasis U₀ nearly diagonalizes the new H; a few damped Jacobi
rotations refine it:

    T = U†HU                    (≈ diagonal)
    S = damped rotation generator from T  (kernel K1, ops/kernels.py)
    U ← orthonormalize(U·(I+S)) or U·(I+S+S²/2)   (Newton–Schulz)

``tracked_eigh`` adds the per-chain residual check and the exact
fallback; the leapfrog uses ``tracked_eigh_nofallback`` and re-anchors
once per sweep instead.  Complex matrices are real (re, im) pairs.  ``precision=None`` keeps the JAX
package's 3-multiplication complex product and any other value its
4-multiplication form; both run as IEEE float32 products on the card (TF32
is off, see the package docstring).
"""

from __future__ import annotations

import torch

from ..models.bdg_real import diagonalize_embedding
from .kernels import rotation_s_parts

#: per-entry rotation cap (exact 2×2 Jacobi angle is ≤ π/4; damping keeps
#: the simultaneous all-pairs update contractive)
S_MAX = 0.1
#: spectral-norm cap on S: Newton–Schulz converges for σ(S) < √2
S_SIGMA_CAP = 1.0


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _spectral_norm_est(sr, si, iters=3):
    """Power-iteration estimate of σ_max(S) per chain, (B,)."""
    B, n = sr.shape[0], sr.shape[-1]
    vr = torch.full((B, n, 1), 1.0, dtype=sr.dtype, device=sr.device) / (
        torch.sqrt(torch.tensor(float(n), dtype=sr.dtype)).to(sr.device))
    vi = torch.zeros_like(vr)

    def mv(vr, vi):
        return sr @ vr - si @ vi, sr @ vi + si @ vr

    for _ in range(iters):
        wr, wi = mv(vr, vi)
        nrm = torch.sqrt(torch.sum(wr * wr + wi * wi, dim=(-2, -1),
                                   keepdim=True)) + 1e-30
        vr, vi = wr / nrm, wi / nrm
    wr, wi = mv(vr, vi)
    return torch.sqrt(torch.sum(wr * wr + wi * wi, dim=(-2, -1)))


def cmm(ar, ai, br, bi, precision=None):
    """(a·b) for complex a, b given as real/imag parts.  ``precision=None``:
    3-multiplication (Karatsuba) form; otherwise the 4-multiplication form."""
    if precision is None:
        m1 = torch.matmul(ar, br)
        m2 = torch.matmul(ai, bi)
        m3 = torch.matmul(ar + ai, br + bi)
        return m1 - m2, m3 - m1 - m2
    mm = torch.matmul
    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def cmm_dag(ar, ai, br, bi, precision=None):
    """(a†·b), with the same 3-multiplication fast path as ``cmm``."""
    if precision is None:
        m1 = torch.matmul(ar.mT, br)
        m2 = torch.matmul(ai.mT, bi)
        m3 = torch.matmul((ar - ai).mT, br + bi)
        return m1 + m2, m3 - m1 + m2
    mm = torch.matmul
    return (mm(ar.mT, br) + mm(ai.mT, bi),
            mm(ar.mT, bi) - mm(ai.mT, br))


def _newton_schulz(ur, ui, precision=None):
    """One step of U ← U(3I − U†U)/2 — re-unitarizes a near-unitary U."""
    gr, gi = cmm_dag(ur, ui, ur, ui, precision)
    mr = 1.5 * _eye(ur.shape[-1], ur) - 0.5 * gr
    mi = -0.5 * gi
    return cmm(ur, ui, mr, mi, precision)


def _project_T(hr, hi, ur, ui, precision=None):
    """T = U†HU and diagnostics: (tr, ti, d, offdiag_inf per chain)."""
    wr, wi = cmm(hr, hi, ur, ui, precision)
    tr, ti = cmm_dag(ur, ui, wr, wi, precision)
    d = torch.diagonal(tr, dim1=-2, dim2=-1)
    mask = 1.0 - _eye(d.shape[-1], tr)
    off = torch.sqrt(tr * tr + ti * ti) * mask
    return tr, ti, d, torch.amax(off, dim=(-2, -1))


def rotation_matrix_parts(tr, ti, d, smax=S_MAX):
    """The damped Jacobi rotation generator S (anti-Hermitian, (sr, si))
    from T = U†HU and its diagonal d — kernel K1 on CUDA tensors, its plain
    version on CPU tensors.  The σ-cap that follows needs all of S, so it
    stays outside the kernel."""
    return rotation_s_parts(tr, ti, d, smax)


def tracked_step(hr, hi, ur, ui, precision=None, ns_steps=2, rot_dtype=None,
                 rot_scheme="ns"):
    """One refinement iteration: rotate toward the eigenbasis.

    ``rot_dtype`` (e.g. ``torch.bfloat16``): storage dtype of the matmul
    operands; the S construction runs in float32.  ``rot_scheme``: "ns" =
    U(I+S), "exp2" = U(I+S+S²/2); ``ns_steps`` Newton–Schulz steps follow.
    """
    if rot_dtype is not None:
        hr, hi = hr.to(rot_dtype), hi.to(rot_dtype)
        ur, ui = ur.to(rot_dtype), ui.to(rot_dtype)
    tr, ti, d, _ = _project_T(hr, hi, ur, ui, precision)
    if rot_dtype is not None:
        tr, ti = tr.to(torch.float32), ti.to(torch.float32)
        d = d.to(torch.float32)

    sr, si = rotation_matrix_parts(tr, ti, d, S_MAX)

    # stability cap: σ(S) ≤ S_SIGMA_CAP keeps Newton–Schulz in its basin
    sigma = _spectral_norm_est(sr, si)
    alpha = torch.clamp(S_SIGMA_CAP / torch.clamp(sigma, min=1e-30),
                        max=1.0)[:, None, None]
    sr = sr * alpha
    si = si * alpha

    if rot_dtype is not None:
        sr, si = sr.to(rot_dtype), si.to(rot_dtype)
    if rot_scheme == "exp2":
        v2r, v2i = cmm(sr, si, sr, si, precision)
        vr = sr + 0.5 * v2r
        vi = si + 0.5 * v2i
        wr, wi = cmm(ur, ui, vr, vi, precision)
        ur, ui = ur + wr, ui + wi
    else:
        vr, vi = cmm(ur, ui, sr, si, precision)      # U S
        ur, ui = ur + vr, ui + vi
    for _ in range(ns_steps):
        ur, ui = _newton_schulz(ur, ui, precision)
    return ur, ui


def rayleigh_corrected_evals(tr, ti, d):
    """Second-order (Padé-damped) eigenvalue correction from T = U†HU:
    e_i ≈ d_i + Σ_{j≠i} |T_ij|²·g_ij/(g_ij² + |T_ij|²), g_ij = d_i − d_j."""
    mask = 1.0 - _eye(d.shape[-1], tr)
    m2 = (tr * tr + ti * ti) * mask
    g = d[..., :, None] - d[..., None, :]
    corr = torch.sum(m2 * g / (g * g + m2 + 1e-30), dim=-1)
    return d + corr


def tracked_eigh_nofallback(hr, hi, ur0, ui0, *, n_iter: int = 6,
                            precision=None, eval_precision=None,
                            ns_steps: int = 2, rot_dtype=None,
                            eval_correction: bool = False,
                            rot_scheme: str = "ns"):
    """``n_iter`` tracked rotations from U₀, then the readout T = U†HU at
    ``eval_precision`` (defaults to ``precision``).  Returns (evals, Ur, Ui,
    off-diagonal residual per chain).  The eigenvalues are NOT sorted: every
    use during a trajectory is order-independent, and the exact anchor
    restores sorted order.  Under ``rot_dtype`` the loop carry is cast once
    and the basis is cast back to the input dtype."""
    cdt = ur0.dtype
    ur, ui = ur0, ui0
    if rot_dtype is not None:
        ur, ui = ur.to(rot_dtype), ui.to(rot_dtype)
    for _ in range(n_iter):
        ur, ui = tracked_step(hr, hi, ur, ui, precision=precision,
                              ns_steps=ns_steps, rot_dtype=rot_dtype,
                              rot_scheme=rot_scheme)
    if rot_dtype is not None:
        ur, ui = ur.to(cdt), ui.to(cdt)
    tr, ti, d, res = _project_T(hr, hi, ur, ui,
                                precision if eval_precision is None
                                else eval_precision)
    if eval_correction:
        d = rayleigh_corrected_evals(tr, ti, d)
    return d, ur, ui, res


def _sort_by_evals(d, ur, ui):
    """Eigenvalues ascending per chain, the basis columns in the same order
    (a stable sort, as ``jnp.argsort``)."""
    order = torch.argsort(d, dim=-1, stable=True)
    cols = order[..., None, :].expand_as(ur)
    return (torch.gather(d, -1, order), torch.gather(ur, -1, cols),
            torch.gather(ui, -1, cols))


def full_eigh_from_parts(hr, hi):
    """Exact solver: the real-symmetric embedding [[hr, −hi], [hi, hr]] of
    H = hr + i·hi through ``models/bdg_real.diagonalize_embedding`` (its
    ``symmetric_eigh`` diagonalizes float32 of dimension ≤ 512 in float64 on
    the card), keeping every second eigenpair as the JAX package does
    (``V[..., ::2]``, ROADMAP fault F0).  A non-finite entry is zeroed in
    the matrix handed to the eigh, as ``sampler/hmc.leapfrog`` does:
    ``torch.linalg.eigh`` raises on NaN where JAX's returns NaN."""
    M = torch.cat([torch.cat([hr, -hi], dim=-1),
                   torch.cat([hi, hr], dim=-1)], dim=-2)
    return diagonalize_embedding(
        torch.where(torch.isfinite(M), M, torch.zeros_like(M)))


def tracked_eigh(hr, hi, ur0, ui0, *, n_iter: int = 3, tol: float = 1e-4):
    """Eigendecomposition of H = hr + i·hi (B, n, n) warm-started at
    U₀ = ur0 + i·ui0: ``n_iter`` tracked rotations (one K1 launch each on
    the card), then the residual check per chain.  A chain whose
    off-diagonal residual exceeds ``tol`` relative to its spectral scale
    max|d| takes ``full_eigh_from_parts``; the others keep the tracked basis
    with the eigenvalues sorted.  Returns (evals ascending, Ur, Ui,
    used_fallback (B,) bool).  A chain with a non-finite residual does not
    fall back, as in the JAX package (NaN > x is false)."""
    ur, ui = ur0, ui0
    for _ in range(n_iter):
        ur, ui = tracked_step(hr, hi, ur, ui)
    _, _, d, res = _project_T(hr, hi, ur, ui)

    scale = torch.clamp(torch.amax(torch.abs(d), dim=-1), min=1e-30)
    bad = res > tol * scale
    evals, Ur, Ui = _sort_by_evals(d, ur, ui)
    if bool(bad.any()):
        evals[bad], Ur[bad], Ui[bad] = full_eigh_from_parts(hr[bad], hi[bad])
    return evals, Ur, Ui, bad
