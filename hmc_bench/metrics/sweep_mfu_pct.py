"""Model FLOPs of the traced periods (the frozen ``tracked_model_flops``
convention: the rotation products only) over the traced window's time,
as a share of the H100's dense BF16 peak."""

from hmc_bench import yardstick as ys


def read(ctx):
    t, cfg = ctx.trace, ctx.cfg
    if t is None or t.window_s <= 0 or ctx.traced_periods == 0:
        return None
    K = max(1, cfg.anchor_every)
    flops = ctx.traced_periods * ys.tracked_model_flops(
        cfg.Lx, cfg.Nt_measure, cfg.n_chains, K, cfg.tracked_iters, K,
        cfg.refine_iters, cfg.polish_iters, cfg.resolved_ns_steps(),
        cfg.rot_scheme)
    return 100.0 * flops / t.window_s / ys.BF16_DENSE_FLOPS
