"""K5 ``spectral_norm_est`` (``ops/kernels``, ``csrc/sigma_cap.cu``): the
σ-cap's power iteration, on the CPU.

* The plain version against the JAX package's ``_spectral_norm_est``
  (``dwavehmc_tpu/ops/tracked_eigh.py``), vmapped over the chains: rtol
  1e-12 in float64 and 1e-5 in float32 (the JAX sum's order is XLA's);
* a block of the batch alone gets the bits it gets inside the batch;
* the dispatcher sends CPU tensors to the plain version and counts no
  launch;
* a model of the kernel's order of additions (a warp per row, each lane
  folding its leaves in bit-reversed order, G a load, then the lane
  shuffles; the norm split over the chain's CTAs by the rows' low bits)
  gives the plain version's bits, at every count of CTAs a chain;
* the launch plan: the most CTAs a chain with which the batch fits on the
  card at once, else the chains in turns; v in shared memory when it
  fits.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py`` ``kernel.sigma_cap``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.ops import tracked_eigh as jte
from dwavehmc_tpu_torch.ops import kernels
from dwavehmc_tpu_torch.ops import tracked_eigh as tte

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]


def _generator(B, n, dtype, seed=0, scale=0.3):
    """An anti-Hermitian S = (sr, si) per chain, as K1 makes it."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((B, n, n), generator=g, dtype=torch.float64)
    b = torch.randn((B, n, n), generator=g, dtype=torch.float64)
    return ((a - a.mT) * scale).to(dtype), ((b + b.mT) * scale).to(dtype)


@pytest.mark.parametrize("n", [5, 72, 257, 1152])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_matches_jax(n, dtype):
    sr, si = _generator(2, n, dtype)
    got = kernels.spectral_norm_est_plain(sr, si)
    assert got.dtype == dtype and got.shape == (2,)
    want = jax.vmap(jte._spectral_norm_est)(jnp.asarray(sr.numpy()),
                                            jnp.asarray(si.numpy()))
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_block_alone_gets_the_batch_bits(dtype):
    sr, si = _generator(5, 257, dtype, seed=1)
    whole = kernels.spectral_norm_est_plain(sr, si)
    for lo, hi in ((0, 2), (2, 5), (4, 5)):
        assert torch.equal(kernels.spectral_norm_est_plain(sr[lo:hi],
                                                           si[lo:hi]),
                           whole[lo:hi])


def test_cpu_dispatch_is_the_plain_version_and_counts_no_launch():
    kernels.reset_launches()
    sr, si = _generator(3, 72, torch.float32, seed=2)
    got = kernels.spectral_norm_est(sr, si)
    assert torch.equal(got, kernels.spectral_norm_est_plain(sr, si))
    assert torch.equal(tte._spectral_norm_est(sr, si), got)
    assert torch.equal(kernels.spectral_norm_est(sr, si, iters=1),
                       kernels.spectral_norm_est_plain(sr, si, iters=1))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# --- the kernel's order of additions --------------------------------------------

def _bitrev(u: int, bits: int) -> int:
    return int(format(u, f"0{bits}b")[::-1], 2) if bits else 0


def _row_sums(x, G: int):
    """Σ over the last axis of x (…, n) as a warp of ``csrc/sigma_cap.cu``
    adds a row: lane l holds x[l + 32 q]; it walks q in bit-reversed
    order, G leaves a chunk added as adjacent pairs, the chunks' sums
    merged by a binary counter; then the halving tree over the 32 lanes."""
    n = x.shape[-1]
    P = kernels.tree_length(n)
    Q = P // 32
    lq = Q.bit_length() - 1
    padded = torch.nn.functional.pad(x, (0, P - n)).reshape(
        *x.shape[:-1], Q, 32)
    stack, s = {}, None
    for c in range(Q // G):
        y = [padded[..., _bitrev(c * G + g, lq), :] for g in range(G)]
        w = 1
        while w < G:
            for j in range(0, G, 2 * w):
                y[j] = y[j] + y[j + w]
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


def _chain_norm(q, ctas: int):
    """Σ_i q_i (q (B, n) ≥ 0) as the kernel's CTAs add it: CTA r holds
    the rows i = r + ctas·k, adds them in a halving tree over k whose slots
    past its rows are skipped, and the CTAs' partials go through the
    halving tree over r."""
    B, n = q.shape
    M = -(-n // ctas)
    parts = []
    for r in range(ctas):
        loc = q[:, r::ctas].clone()
        live = loc.shape[-1]
        h = 1
        while h < M:
            h *= 2
        h //= 2
        while h >= 1:
            m = max(0, min(h, live - h))
            loc[:, :m] = loc[:, :m] + loc[:, h:h + m]
            live = min(live, h)
            h //= 2
        parts.append(loc[:, 0] if loc.shape[-1] else torch.zeros_like(q[:, 0]))
    p = torch.stack(parts, dim=-1)
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def _kernel_model(sr, si, iters: int, ctas: int, G: int):
    B, n = sr.shape[0], sr.shape[-1]
    root_n = torch.sqrt(torch.full((), float(n), dtype=sr.dtype))
    vr = torch.full((B, n), 1.0, dtype=sr.dtype) / root_n
    vi = torch.zeros_like(vr)
    for p in range(iters + 1):
        r, i = vr[:, None, :], vi[:, None, :]
        wr = _row_sums(sr * r, G) - _row_sums(si * i, G)
        wi = _row_sums(sr * i, G) + _row_sums(si * r, G)
        s = _chain_norm(wr * wr + wi * wi, ctas)
        if p == iters:
            return torch.sqrt(s)
        nrm = torch.sqrt(s)[:, None] + 1e-30
        vr, vi = wr / nrm, wi / nrm


# the kernel's chunks: 16 float32 leaves (8 where a lane has 8), 4 float64
@pytest.mark.parametrize("n,dtype,G", [
    (n, dtype, G) for n in (5, 33, 257, 1152)
    for dtype, G in ((torch.float32, 16), (torch.float32, 8),
                     (torch.float64, 4))
    if kernels.tree_length(n) // 32 >= G])
@pytest.mark.parametrize("ctas", [1, 4, 16, 128])
def test_the_kernels_order_is_the_plain_versions(n, ctas, dtype, G):
    sr, si = _generator(2, n, dtype, seed=3, scale=30.0)
    assert torch.equal(_kernel_model(sr, si, 3, ctas, G),
                       kernels.spectral_norm_est_plain(sr, si))


def test_the_model_sees_the_walk_order():
    """Without the bit reversal the lanes' fold is another tree, and the
    bits differ (so the test above can fail)."""
    x = torch.randn((4, 1152), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64).float() * 1e3
    want = kernels.chain_sum_plain(x)
    assert torch.equal(_row_sums(x, 8), want)
    global _bitrev
    real = _bitrev
    try:
        _bitrev = lambda u, bits: u  # noqa: E731
        assert not torch.equal(_row_sums(x, 8), want)
    finally:
        _bitrev = real


# --- the launch plan ------------------------------------------------------------

#: each CTA's copy rings: 8 warps × 3 stages × 2 matrices × G × 32 lanes
RING = {4: 8 * 3 * 2 * 16 * 32, 8: 8 * 3 * 2 * 4 * 32}


def test_shared_memory_layout():
    assert kernels.sigma_cap_smem(1152, 16, 4, True) == 4 * (
        RING[4] + 2304 + 3 * 72 + 16 + 1)
    assert kernels.sigma_cap_smem(1152, 16, 4, False) == 4 * (
        RING[4] + 3 * 72 + 17)
    assert kernels.sigma_cap_smem(5, 16, 8, True) == 8 * (RING[8] + 10 + 3
                                                          + 17)
    # a 256-leaf float32 row takes chunks of 8
    assert kernels.sigma_cap_smem(200, 1, 4, True) == 4 * (
        RING[4] // 2 + 400 + 600 + 2)


def _card(per_sm: int, sms: int = 132):
    """A stand-in for the card's residency: ``per_sm`` CTAs an SM."""
    return lambda v_in_smem, smem: per_sm * sms


def test_the_batch_fits_on_the_card_at_once():
    # 8 chains of 1152: 32 CTAs a chain fill 256 of 264 places
    plan = kernels.choose_sigma_cap_plan(8, 1152, 4, _card(2))
    assert plan == kernels.SigmaCapPlan(
        32, True, kernels.sigma_cap_smem(1152, 32, 4, True), 8)
    # two chains: 128 CTAs each; one float64 chain at 8464, one CTA an SM
    assert kernels.choose_sigma_cap_plan(2, 4232, 4, _card(2)).ctas == 128
    plan = kernels.choose_sigma_cap_plan(1, 8464, 8, _card(1))
    assert plan.ctas == 128 and plan.v_in_smem and plan.at_once == 1
    # n bounds the CTAs a chain; 64 chains fit at 4 CTAs each
    assert kernels.choose_sigma_cap_plan(1, 100, 4, _card(2)).ctas == 64
    plan = kernels.choose_sigma_cap_plan(64, 1152, 4, _card(2))
    assert (plan.ctas, plan.at_once) == (4, 64)


def test_a_batch_too_large_for_the_card_runs_in_turns():
    plan = kernels.choose_sigma_cap_plan(100, 1152, 4, _card(2))
    assert plan == kernels.SigmaCapPlan(
        16, True, kernels.sigma_cap_smem(1152, 16, 4, True), 16)
    # a card that holds fewer than 16 CTAs cannot take the call
    with pytest.raises(ValueError, match="no launch fits"):
        kernels.choose_sigma_cap_plan(100, 1152, 4, _card(1, sms=8))


def test_the_plan_reads_v_from_l2_where_it_does_not_fit():
    got = {ctas: kernels._sigma_cap_layout(8464, ctas, 8)
           for ctas in kernels.SIGMA_CAP_CTAS}
    assert got[128] == (True, 8 * (RING[8] + 2 * 8464 + 3 * 67 + 129))
    assert got[4] == (False, 8 * (RING[8] + 3 * 2116 + 5))
    assert all(s <= kernels.SIGMA_CAP_SMEM_MAX for _, s in got.values())
    assert kernels._sigma_cap_layout(8464, 1, 8) is None
    with pytest.raises(ValueError, match="no launch fits"):
        kernels.choose_sigma_cap_plan(1, 10**7, 8, _card(2))
