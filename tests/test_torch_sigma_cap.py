"""K5 ``spectral_norm_est`` (``ops/kernels``, ``csrc/sigma_cap.cu``): the
σ-cap's power iteration, on the CPU.

* The plain version against the JAX package's ``_spectral_norm_est``
  (``dwavehmc_tpu/ops/tracked_eigh.py``), vmapped over the chains: rtol
  1e-12 in float64 and 1e-5 in float32 (the JAX sum's order is XLA's);
* a block of the batch alone gets the bits it gets inside the batch;
* the dispatcher sends CPU tensors to the plain version and counts no
  launch;
* a model of the kernel's order of additions (each tree folded to the
  largest power of two ≤ n after its one partial level, a warp per row,
  each lane folding its leaves in bit-reversed order, G a load, then the
  lane shuffles; the norm over all of w, as every CTA adds it after the
  pass's one barrier) gives the plain version's bits, also where S holds
  −0.0 entries, and a wrong order does not;
* the launch plan: S kept in the CTAs' shared memory where every chain
  fits at once with its rows, else streamed at the most CTAs a chain with
  which the batch fits at once (v read from L2 where it does not fit in
  shared memory), else the chains in turns.

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


def _fold(x, least: int):
    """x (…, n) on the H = ``kernels.fold_length(n, least)`` leaves of its
    folded tree: x[i] + x[i + H] for i < n − H (the plain tree's one
    partial level; the levels above it add padding), zeros past n."""
    n = x.shape[-1]
    H = kernels.fold_length(n, least)
    y = torch.nn.functional.pad(x, (0, max(0, H - n)))[..., :H].clone()
    if n > H:
        y[..., :n - H] = y[..., :n - H] + x[..., H:]
    return y


def _row_sums(x, G: int):
    """Σ over the last axis of x (…, n) as a warp of ``csrc/sigma_cap.cu``
    adds a row: the folded tree's leaves, lane l holding leaf l + 32 q; it
    walks q in bit-reversed order, G leaves a chunk added as adjacent
    pairs, the chunks' sums merged by a binary counter; then the halving
    tree over the 32 lanes."""
    y = _fold(x, 32)
    Q = y.shape[-1] // 32
    lq = Q.bit_length() - 1
    G = min(G, Q)
    leaves = y.reshape(*x.shape[:-1], Q, 32)
    stack, s = {}, None
    for c in range(Q // G):
        z = [leaves[..., _bitrev(c * G + g, lq), :] for g in range(G)]
        w = 1
        while w < G:
            for j in range(0, G, 2 * w):
                z[j] = z[j] + z[j + w]
            w *= 2
        s, level = z[0], 0
        while (c >> level) & 1:
            s = stack.pop(level) + s
            level += 1
        stack[level] = s
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def _chain_norm(q):
    """Σ_i q_i (q (B, n) ≥ 0) as every CTA of a chain adds it: the folded
    tree over ``fold_length(n, 64)`` leaves, its top level as the terms are
    read, the levels down to 32 in shared memory, the last five shuffles
    (one halving tree)."""
    y = _fold(q, 64)
    h = y.shape[-1] // 2
    z = y[..., :h] + y[..., h:]
    while z.shape[-1] > 1:
        h = z.shape[-1] // 2
        z = z[..., :h] + z[..., h:]
    return z[..., 0]


def _kernel_model(sr, si, iters: int, G: int):
    """K5's passes: each row's four trees, w = (rr − ii, ri + ir) published
    unnormalized, then every CTA's norm over all of w and v = w / nrm."""
    B, n = sr.shape[0], sr.shape[-1]
    root_n = torch.sqrt(torch.full((), float(n), dtype=sr.dtype))
    vr = torch.full((B, n), 1.0, dtype=sr.dtype) / root_n
    vi = torch.zeros_like(vr)
    for p in range(iters + 1):
        r, i = vr[:, None, :], vi[:, None, :]
        wr = _row_sums(sr * r, G) - _row_sums(si * i, G)
        wi = _row_sums(sr * i, G) + _row_sums(si * r, G)
        s = _chain_norm(wr * wr + wi * wi)
        if p == iters:
            return torch.sqrt(s)
        nrm = torch.sqrt(s)[:, None] + 1e-30
        vr, vi = wr / nrm, wi / nrm


def _with_signed_zeros(sr, si, seed: int):
    """S with −0.0 entries: a zero diagonal of mixed signs (K1 writes its
    diagonal as a product with 0), a row of −0.0 and a row of mixed ±0."""
    n = sr.shape[-1]
    g = torch.Generator().manual_seed(seed)
    sign = torch.where(torch.rand(sr.shape[:-1], generator=g) < 0.5,
                       -0.0, 0.0).to(sr.dtype)
    sr, si = sr.clone(), si.clone()
    sr.diagonal(dim1=-2, dim2=-1).copy_(sign)
    si.diagonal(dim1=-2, dim2=-1).copy_(sign.flip(-1))
    sr[:, 0] = -0.0
    si[:, 0] = -0.0
    sr[:, n // 2] = sign
    si[:, n // 2] = -0.0
    return sr, si


# the kernel's loads: 16 float32 leaves, 8 float64 (4 where partners fall
# anywhere), and other splits of the same walk
@pytest.mark.parametrize("n,dtype,G", [
    (n, dtype, G) for n in (32, 72, 257, 300, 513, 1000, 1152)
    for dtype, G in ((torch.float32, 32), (torch.float32, 16),
                     (torch.float64, 8), (torch.float64, 4))])
@pytest.mark.parametrize("zeros", [False, True])
def test_the_kernels_order_is_the_plain_versions(n, zeros, dtype, G):
    sr, si = _generator(2, n, dtype, seed=3, scale=30.0)
    if zeros:
        sr, si = _with_signed_zeros(sr, si, seed=n)
        assert bool((torch.signbit(sr) & (sr == 0)).any())
    assert torch.equal(_kernel_model(sr, si, 3, G),
                       kernels.spectral_norm_est_plain(sr, si))


def test_the_model_sees_the_walk_order():
    """Without the bit reversal the lanes' fold is another tree, and so is
    a partial level that pairs the tail with the wrong leaves: the bits
    differ (so the test above can fail)."""
    x = torch.randn((4, 1152), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64).float() * 1e3
    want = kernels.chain_sum_plain(x)
    assert torch.equal(_row_sums(x, 8), want)
    global _bitrev, _fold
    real_bitrev, real_fold = _bitrev, _fold

    def fold_to_the_end(x, least):
        n = x.shape[-1]
        H = kernels.fold_length(n, least)
        y = x[..., :H].clone()
        y[..., 2 * H - n:] = y[..., 2 * H - n:] + x[..., H:]
        return y

    try:
        _bitrev = lambda u, bits: u  # noqa: E731
        assert not torch.equal(_row_sums(x, 8), want)
        _bitrev, _fold = real_bitrev, fold_to_the_end
        assert not torch.equal(_row_sums(x, 8), want)
    finally:
        _bitrev, _fold = real_bitrev, real_fold


@pytest.mark.parametrize("n,H,lq", [(1, 32, 0), (32, 32, 0), (63, 32, 0),
                                    (64, 64, 1), (512, 512, 4),
                                    (1152, 1024, 5), (4232, 4096, 7),
                                    (8464, 8192, 8)])
def test_the_fold_drops_the_padding_leaves(n, H, lq):
    """A row's folded tree has H = the largest power of two ≤ n leaves (32
    at least), 2^lq a lane; the plain tree has ``tree_length(n)``."""
    assert kernels.fold_length(n, 32) == H
    assert kernels.sigma_cap_lq(n) == lq
    assert kernels.tree_length(n) >= H and H <= max(n, 32) < 2 * H


# --- the launch plan ------------------------------------------------------------

def test_shared_memory_layout():
    # v as pairs, the norm's fold_length(n, 64) / 2 values and a broadcast
    # slot; on chip also the CTA's ⌈n / ctas⌉ rows of sr and of si
    assert kernels.sigma_cap_smem(1152, 16, 4, "stream") == 4 * (
        2304 + 512 + 1)
    assert kernels.sigma_cap_smem(1152, 16, 4, "v_in_l2") == 4 * (512 + 1)
    assert kernels.sigma_cap_smem(512, 16, 4, "on_chip") == 4 * (
        1024 + 256 + 1 + 2 * 32 * 512)
    assert kernels.sigma_cap_smem(5, 1, 8, "on_chip") == 8 * (
        10 + 32 + 1 + 2 * 5 * 5)
    assert kernels.sigma_cap_smem(8464, 132, 8, "stream") == 8 * (
        16928 + 4096 + 1)


def _card(per_sm: int, sms: int = 132):
    """A stand-in for the card's residency: ``per_sm`` CTAs an SM."""
    return lambda mode, smem: per_sm * sms


def test_the_batch_fits_on_the_card_at_once():
    # 8 chains of 1152: 16 CTAs a chain fill 128 of 132 places; S streams
    plan = kernels.choose_sigma_cap_plan(8, 1152, 4, _card(1))
    assert plan == kernels.SigmaCapPlan(
        16, "stream", kernels.sigma_cap_smem(1152, 16, 4, "stream"), 8)
    # the scan's 24 chains at 5 CTAs each, the 24×24/b64 leg's 64 at 2,
    # their warps' rows first streamed into L2
    assert kernels.choose_sigma_cap_plan(24, 1152, 4, _card(1))[:2] == (
        5, "stream")
    plan = kernels.choose_sigma_cap_plan(64, 1152, 4, _card(1))
    assert (plan.ctas, plan.mode, plan.at_once, plan.prefetch) == (
        2, "stream", 64, True)
    # two chains of 4232: 66 CTAs each; one float64 chain of 8464 on every
    # SM, v in shared memory (168 KB a CTA)
    assert kernels.choose_sigma_cap_plan(2, 4232, 4, _card(1)).ctas == 66
    plan = kernels.choose_sigma_cap_plan(1, 8464, 8, _card(1))
    assert (plan.ctas, plan.mode, plan.at_once) == (132, "stream", 1)
    # n bounds the CTAs a chain
    assert kernels.choose_sigma_cap_plan(1, 100, 4, _card(1)).ctas == 100


def test_s_stays_on_chip_where_the_batch_fits():
    """The 16×16/b8 headline's (8, 512): 16 CTAs a chain, 32 rows each of
    sr and si beside v, about 135 KB a CTA, every chain at once; a single
    chain of 1152 too (9 rows a CTA on 128 CTAs)."""
    plan = kernels.choose_sigma_cap_plan(8, 512, 4, _card(1))
    assert plan == kernels.SigmaCapPlan(
        16, "on_chip", kernels.sigma_cap_smem(512, 16, 4, "on_chip"), 8)
    assert 130_000 < plan.smem_bytes <= kernels.SIGMA_CAP_SMEM_MAX
    plan = kernels.choose_sigma_cap_plan(1, 1152, 4, _card(1))
    assert (plan.mode, plan.ctas) == ("on_chip", 132)
    # too many rows a CTA: the 24×24 batches and config 5's stream
    for B, n in ((8, 1152), (64, 1152), (2, 2048)):
        assert kernels.choose_sigma_cap_plan(B, n, 4, _card(1)).mode \
            == "stream"


@pytest.mark.parametrize("B,n,itemsize,prefetch", [
    (8, 512, 4, False), (8, 1152, 4, False), (24, 1152, 4, True),
    (64, 1152, 4, True), (2, 2048, 4, False), (2, 4232, 4, False),
    (1, 8464, 8, False)])
def test_every_sm_keeps_its_warps_in_flight(B, n, itemsize, prefetch):
    """One CTA of 16 warps an SM at every shape (128 registers a thread: 16
    float32 leaves in flight a lane, 4 float64); the L2 prefetch where a
    warp streams at least 8 rows a pass."""
    plan = kernels.choose_sigma_cap_plan(B, n, itemsize, _card(1))
    assert kernels.SIGMA_CAP_WARPS == 16
    assert plan.ctas * plan.at_once <= 132
    assert plan.prefetch == prefetch
    rows = -(-n // plan.ctas)
    assert (-(-rows // 16) >= kernels.SIGMA_CAP_PREFETCH_ROWS) == prefetch


def test_a_batch_too_large_for_the_card_runs_in_turns():
    plan = kernels.choose_sigma_cap_plan(200, 1152, 4, _card(1))
    assert plan == kernels.SigmaCapPlan(
        1, "stream", kernels.sigma_cap_smem(1152, 1, 4, "stream"), 132,
        True)
    # a card that holds none cannot take the call
    with pytest.raises(ValueError, match="no launch fits"):
        kernels.choose_sigma_cap_plan(100, 1152, 4, _card(0))


def test_the_plan_reads_v_from_l2_where_it_does_not_fit():
    # v of 8464 doubles fits a CTA; of 30000 floats (240 KB) it does not
    assert kernels.choose_sigma_cap_plan(1, 8464, 8, _card(1)).mode \
        == "stream"
    assert kernels.sigma_cap_smem(30000, 1, 4, "stream") \
        > kernels.SIGMA_CAP_SMEM_MAX
    plan = kernels.choose_sigma_cap_plan(1, 30000, 4, _card(1))
    assert plan == kernels.SigmaCapPlan(132, "v_in_l2", 4 * (8192 + 1), 1,
                                        True)
    # past the longest rows the kernels are built for
    with pytest.raises(ValueError, match="no launch fits"):
        kernels.choose_sigma_cap_plan(1, 65536, 8, _card(1))


def test_a_variant_rewrites_the_float32_constants():
    """``drivers/sigma_cap_variants`` rebuilds K5 with other constants of
    one type; the other type's constants and the rest of the source
    stay."""
    from dwavehmc_tpu_torch.drivers import sigma_cap_variants as sv

    src = (kernels.CSRC_DIR / "sigma_cap.cu").read_text()
    f32 = src[src.index("struct Cfg<float>"):src.index("struct Cfg<double>")]
    f64 = src[src.index("struct Cfg<double>"):src.index("// A row's flavor")]
    got = sv.variant_source(src, "float:32:8,4:2")
    assert "kWarps = 32, kSlots = 2;\n  static constexpr int kGOf[2] = " \
        "{8, 4};" in got
    assert f64 in got and f32 not in got
    got = sv.variant_source(src, "double:8:4,2:1")
    assert "kWarps = 8, kSlots = 1;\n  static constexpr int kGOf[2] = " \
        "{4, 2};" in got
    assert f32 in got and f64 not in got
    with pytest.raises(ValueError, match="type:warps:sparse,dense:slots"):
        sv.variant_source(src, "float:32:16")
