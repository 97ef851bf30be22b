"""The frozen yardstick against the program's own copy and the port's
kernel table."""

import pytest

from hmc_bench import yardstick as ys


@pytest.mark.parametrize("L,Nt,B,K,refine,polish,ns,scheme", [
    (24, 6, 64, 10, 6, 3, 1, "exp2"),     # 24×24/b64 under the fast mix
    (16, 6, 8, 10, 6, 3, 1, "exp2"),      # dwave16_b8.fast
    (24, 6, 64, 1, 12, 4, 1, "exp2"),     # the scan's measurement sweep
    (24, 20, 8, 1, 12, 4, 2, "ns"),
])
def test_flops_match_the_program(L, Nt, B, K, refine, polish, ns, scheme):
    from dwavehmc_tpu_torch.utils.flops import tracked_model_flops

    for sweeps in (K, 2 * K, 3):
        args = (L, Nt, B, sweeps, 6, K, refine, polish, ns, scheme)
        assert ys.tracked_model_flops(*args) == tracked_model_flops(*args)


def test_peaks_match_the_program():
    from dwavehmc_tpu_torch.utils import flops

    assert ys.BF16_DENSE_FLOPS == flops.H100_BF16_DENSE_PEAK_TFLOPS * 1e12
    assert ys.HBM_BYTES_PER_S == flops.H100_HBM_BYTES_PER_S


@pytest.mark.parametrize("fn,args,table_ms", [
    (ys.k1_seconds, (8, 1152), 0.0507),
    (ys.k1_seconds, (8, 512), 0.0100),
    (ys.k1_seconds, (64, 1152), 0.406),
    (ys.k1_seconds, (40, 2048), 0.801),
    (ys.k5_seconds, (8, 1152), 0.0254),
    (ys.k5_seconds, (8, 512), 0.0050),
    (ys.k5_seconds, (64, 1152), 0.2028),
    (ys.k5_seconds, (24, 1152), 0.0761),
    (ys.k1_seconds, (2, 2048), 0.0401),
    (ys.k5_seconds, (2, 2048), 0.0200),
    (ys.k5_seconds, (2, 4232), 0.0855),
])
def test_bounds_match_the_kernel_table(fn, args, table_ms):
    """PERF.md's kernel table gives each bound to three or four digits."""
    assert fn(*args) * 1e3 == pytest.approx(table_ms, rel=6e-3)
