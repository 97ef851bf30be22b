"""Host milliseconds inside the program's ``dwavehmc.sync.*`` spans (each
around one blocking read of a device value: the host waiting for the
device) over the traced chain-trajectories.  The program's
``utils/profiling.SPANS`` records spans only while a profiler is on: the
traced periods; no traced ``dwavehmc.sweep`` reads as no value."""

PREFIX = "dwavehmc.sync."


def read(ctx):
    from dwavehmc_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", {})
    if "dwavehmc.sweep" not in spans or ctx.traced_traj == 0:
        return None
    s = sum(rec[1] for name, rec in spans.items() if name.startswith(PREFIX))
    return 1e3 * s / ctx.traced_traj
