"""Tracked (warm-started) Hermitian eigensolver for the leapfrog hot loop.

Port of ``dwavehmc_tpu/ops/tracked_eigh.py`` over a leading chain
dimension.  Inside one leapfrog step H changes by O(dt), so the previous
step's eigenbasis U₀ nearly diagonalizes the new H; a few damped Jacobi
rotations refine it:

    T = U†HU                    (≈ diagonal)
    S = damped rotation generator from T  (kernel K1, ops/kernels.py)
    U ← orthonormalize(U·(I+S)) or U·(I+S+S²/2)   (Newton–Schulz)

The σ-cap's power iteration is one launch of K5
(``ops/kernels.spectral_norm_est``), which adds in one order whatever the
batch, so a chain's rotation does not depend on its neighbours in the
batch.  ``tracked_eigh`` adds the per-chain residual
check and the exact fallback; the leapfrog uses ``tracked_eigh_nofallback`` and re-anchors
once per sweep instead.  Complex matrices are real (re, im) pairs.
``precision=None`` keeps the JAX package's 3-multiplication complex product
and any other value its 4-multiplication form.  ``None`` and "highest" run
as IEEE float32 products on the card (TF32 is off, see the package
docstring); "high" (three TF32 products per product) and "default" (one)
run inside ``utils/precision.matmul_precision`` (the polish rotations of
``sampler/hmc_real.tracked_leapfrog`` at ``polish_precision="high"``).

The factor W = H·U of T = U†(HU) is one launch of K6
(``ops/kernels.bdg_hop``), which reads H's own entries, where the caller
passes H's table (``hop``, from ``hop_table``) and the product is a float32
IEEE one (float32 operands at ``None`` or "highest"); the bf16 rotations
and the TF32 precisions keep the dense product (``_h_times``).
"""

from __future__ import annotations

import functools

import torch

from ..models.bdg_real import diagonalize_embedding, hamiltonian_columns
from ..models.lattice import LatticeSpec
from ..utils.precision import matmul_precision, product
from ..utils.profiling import sync_span
from .kernels import (
    LAUNCHES,
    HopTable,
    bdg_hop,
    bdg_hop_table,
    chain_sum,
    rotation_s_parts,
    spectral_norm_est,
)

#: per-entry rotation cap (exact 2×2 Jacobi angle is ≤ π/4; damping keeps
#: the simultaneous all-pairs update contractive)
S_MAX = 0.1
#: spectral-norm cap on S: Newton–Schulz converges for σ(S) < √2
S_SIGMA_CAP = 1.0


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _spectral_norm_est(sr, si, iters=3):
    """Power-iteration estimate of σ_max(S) per chain, (B,): K5
    (``ops/kernels.spectral_norm_est``), one launch on the card, whose
    order of addition does not depend on the batch."""
    return spectral_norm_est(sr, si, iters)


def cmm(ar, ai, br, bi, precision=None):
    """(a·b) for complex a, b given as real/imag parts.  ``precision=None``:
    3-multiplication (Karatsuba) form; otherwise the 4-multiplication form."""
    if precision is None:
        m1 = torch.matmul(ar, br)
        m2 = torch.matmul(ai, bi)
        m3 = torch.matmul(ar + ai, br + bi)
        return m1 - m2, m3 - m1 - m2
    mm = product(precision)
    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def cmm_dag(ar, ai, br, bi, precision=None):
    """(a†·b), with the same 3-multiplication fast path as ``cmm``."""
    if precision is None:
        m1 = torch.matmul(ar.mT, br)
        m2 = torch.matmul(ai.mT, bi)
        m3 = torch.matmul((ar - ai).mT, br + bi)
        return m1 + m2, m3 - m1 + m2
    mm = product(precision)
    return (mm(ar.mT, br) + mm(ai.mT, bi),
            mm(ar.mT, bi) - mm(ai.mT, br))


def _newton_schulz(ur, ui, precision=None):
    """One step of U ← U(3I − U†U)/2 — re-unitarizes a near-unitary U."""
    gr, gi = cmm_dag(ur, ui, ur, ui, precision)
    mr = 1.5 * _eye(ur.shape[-1], ur) - 0.5 * gr
    mi = -0.5 * gi
    return cmm(ur, ui, mr, mi, precision)


@functools.lru_cache(maxsize=None)
def hop_table(lat: LatticeSpec, device: torch.device) -> HopTable:
    """K6's table of ``lat``'s H on ``device``
    (``models/bdg_real.hamiltonian_columns`` and its launch plan), copied
    once a lattice and device: the copy from pageable host memory waits
    for the stream, a host sync, and a CUDA graph cannot hold it."""
    with sync_span("hop_table"):
        return bdg_hop_table(*hamiltonian_columns(lat), device)


def _h_times(hr, hi, ur, ui, precision=None, hop: HopTable | None = None):
    """W = H·U.  A float32 IEEE product (float32 operands, ``precision``
    None or "highest") with H's table ``hop`` is K6; any other takes
    ``cmm``, and a float32 IEEE one on the card adds one to
    ``LAUNCHES["hu_dense"]``."""
    ieee32 = (precision in (None, "highest")
              and hr.dtype == ur.dtype == torch.float32)
    if ieee32 and hop is not None:
        return bdg_hop(hr, hi, hop, ur, ui)
    if ieee32 and ur.is_cuda:
        LAUNCHES["hu_dense"] += 1
    return cmm(hr, hi, ur, ui, precision)


def _project_T(hr, hi, ur, ui, precision=None, hop: HopTable | None = None):
    """T = U†HU: (tr, ti, d), d its diagonal; H·U through ``_h_times``."""
    wr, wi = _h_times(hr, hi, ur, ui, precision, hop)
    tr, ti = cmm_dag(ur, ui, wr, wi, precision)
    return tr, ti, torch.diagonal(tr, dim1=-2, dim2=-1)


def offdiag_residual(tr, ti):
    """max |T_ij| off the diagonal per chain, (B,): the JAX package's
    fourth output of ``_project_T``, which only the readouts return."""
    mask = 1.0 - _eye(tr.shape[-1], tr)
    off = torch.sqrt(tr * tr + ti * ti) * mask
    return torch.amax(off, dim=(-2, -1))


def rotation_matrix_parts(tr, ti, d, smax=S_MAX):
    """The damped Jacobi rotation generator S (anti-Hermitian, (sr, si))
    from T = U†HU and its diagonal d — kernel K1 on CUDA tensors, its plain
    version on CPU tensors.  The σ-cap that follows needs all of S, so it
    stays outside the kernel."""
    return rotation_s_parts(tr, ti, d, smax)


def tracked_step(hr, hi, ur, ui, precision=None, ns_steps=2, rot_dtype=None,
                 rot_scheme="ns", hop: HopTable | None = None):
    """One refinement iteration: rotate toward the eigenbasis.

    ``rot_dtype`` (e.g. ``torch.bfloat16``): storage dtype of the matmul
    operands; the S construction runs in float32.  ``rot_scheme``: "ns" =
    U(I+S), "exp2" = U(I+S+S²/2); ``ns_steps`` Newton–Schulz steps follow.
    ``hop``: H's K6 table (``_h_times``).
    """
    if rot_dtype is not None:
        hr, hi = hr.to(rot_dtype), hi.to(rot_dtype)
        ur, ui = ur.to(rot_dtype), ui.to(rot_dtype)
    tr, ti, d = _project_T(hr, hi, ur, ui, precision, hop)
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
    corr = chain_sum(m2 * g / (g * g + m2 + 1e-30))
    return d + corr


def tracked_eigh_nofallback(hr, hi, ur0, ui0, *, n_iter: int = 6,
                            precision=None, eval_precision=None,
                            ns_steps: int = 2, rot_dtype=None,
                            eval_correction: bool = False,
                            rot_scheme: str = "ns",
                            hop: HopTable | None = None):
    """``n_iter`` tracked rotations from U₀, then the readout T = U†HU at
    ``eval_precision`` (defaults to ``precision``), each product at its
    precision (``utils/precision.matmul_precision``).  Returns (evals, Ur,
    Ui, off-diagonal residual per chain).  The eigenvalues are NOT sorted:
    every use during a trajectory is order-independent, and the exact
    anchor restores sorted order.  Under ``rot_dtype`` the loop carry is
    cast once and the basis is cast back to the input dtype.  ``hop``: H's
    K6 table, for the float32 IEEE products by H (``_h_times``)."""
    cdt = ur0.dtype
    ur, ui = ur0, ui0
    if rot_dtype is not None:
        ur, ui = ur.to(rot_dtype), ui.to(rot_dtype)
    with matmul_precision(precision, ur0.device):
        for _ in range(n_iter):
            ur, ui = tracked_step(hr, hi, ur, ui, precision=precision,
                                  ns_steps=ns_steps, rot_dtype=rot_dtype,
                                  rot_scheme=rot_scheme, hop=hop)
    if rot_dtype is not None:
        ur, ui = ur.to(cdt), ui.to(cdt)
    readout = precision if eval_precision is None else eval_precision
    with matmul_precision(readout, ur0.device):
        tr, ti, d = _project_T(hr, hi, ur, ui, readout, hop)
    res = offdiag_residual(tr, ti)
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
    tr, ti, d = _project_T(hr, hi, ur, ui)
    res = offdiag_residual(tr, ti)

    scale = torch.clamp(torch.amax(torch.abs(d), dim=-1), min=1e-30)
    bad = res > tol * scale
    evals, Ur, Ui = _sort_by_evals(d, ur, ui)
    with sync_span("tracked_fallback"):
        any_bad = bool(bad.any())
    if any_bad:
        evals[bad], Ur[bad], Ui[bad] = full_eigh_from_parts(hr[bad], hi[bad])
    return evals, Ur, Ui, bad
