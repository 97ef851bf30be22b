"""K2's launch geometry (``ops/kernels._lorentzian_launch``), checked on the
CPU against the index map that ``csrc/lorentzian.cu`` uses: every frequency
and every pair is visited exactly once, the σ(ω) grid is covered without
padding waste, and the block fits the card (whole warps, at most 1024
threads, and the shared memory a block takes without an opt-in, 48 KB,
well inside the 227 KB an H100 block can have)."""

import numpy as np
import pytest

from dwavehmc_tpu_torch.ops import kernels


def _frequencies(g):
    t, r, lane = np.meshgrid(np.arange(g.n_tiles), np.arange(g.R),
                             np.arange(g.tile_w), indexing="ij")
    return (t * g.tile_w * g.R + r * g.tile_w + lane).ravel()


def _pairs(g):
    """Pair index of every (chunk, pair lane, double, half) slot: lane q
    reads doubles q, q + pair_lanes, … of its chunk."""
    c, q, i, k = np.meshgrid(np.arange(g.n_chunks), np.arange(g.pair_lanes),
                             np.arange(-(-g.chunk // 2 // g.pair_lanes)),
                             np.arange(2), indexing="ij")
    j = q + i * g.pair_lanes
    return (c * g.chunk + 2 * j + k)[j < g.chunk // 2]


@pytest.mark.parametrize("M", [0, 1000, 1_327_104])
@pytest.mark.parametrize("n_w", [1, 5, 37, 1436, 2049])
def test_lorentzian_launch_covers_and_fits(n_w, M):
    g = kernels._lorentzian_launch(n_w, M)
    w = _frequencies(g)
    w = w[w < n_w]
    assert np.array_equal(np.sort(w), np.arange(n_w))          # once each
    assert g.columns == w.size + int(np.sum(_frequencies(g) >= n_w))
    p = _pairs(g)
    p = p[p < M]
    assert np.array_equal(np.sort(p), np.arange(M))             # once each
    assert g.chunk % 2 == 0 and g.n_chunks == max(1, -(-M // g.chunk))
    # the kernel is instantiated for one pair lane with R in LORENTZ_R, and
    # for R = 1 with more lanes
    assert ((g.pair_lanes == 1 and g.R in kernels.LORENTZ_R)
            or (g.pair_lanes > 1 and g.R == 1))
    assert g.pair_lanes & (g.pair_lanes - 1) == 0
    assert g.threads % 32 == 0 and g.threads <= 1024
    assert g.smem_bytes <= 48 * 1024 <= 227 * 1024
    if n_w == 1436:
        assert g.columns <= 1.1 * n_w
        assert g.pair_lanes == 1 and g.R >= 4      # pairs reused R times
    if n_w == 1:
        assert g.pair_lanes == 256                  # DC: pairs split 256 ways
