"""The program's ``dwavehmc.sync.*`` spans (one a blocking read of a device
value by the host) over the traced sweeps, chain-trajectories over
chains.  The program's ``utils/profiling.SPANS`` records spans only while
a profiler is on: the traced periods; no traced ``dwavehmc.sweep`` reads
as no value."""

PREFIX = "dwavehmc.sync."


def read(ctx):
    from dwavehmc_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", {})
    if "dwavehmc.sweep" not in spans or ctx.traced_traj == 0:
        return None
    n = sum(rec[0] for name, rec in spans.items() if name.startswith(PREFIX))
    return n * ctx.cfg.n_chains / ctx.traced_traj
