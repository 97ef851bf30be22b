"""K1's bytes bound (16n² + 4n a chain at 3.35 TB/s, every launch at the
cell's (chains, 2N, 2N)) times its launches, over its device time."""

from hmc_bench import trace as tr
from hmc_bench import yardstick as ys


def read(ctx):
    if ctx.trace is None:
        return None
    n_launch, secs = 0, 0.0
    for name, (count, s) in ctx.trace.by_name.items():
        if tr.family(name) == "K1 rotation_s":
            n_launch, secs = n_launch + count, secs + s
    if n_launch == 0 or secs <= 0:
        return None
    cfg = ctx.cfg
    bound = ys.k1_seconds(cfg.n_chains, 2 * cfg.Lx * cfg.Ly)
    return 100.0 * n_launch * bound / secs
