"""Host milliseconds inside the program's ``dwavehmc.anchor`` spans (the
exact accept: the proposals' embedding, the guarded PH solve and the
Metropolis step) over the traced chain-trajectories.  The program's
``utils/profiling.SPANS`` records spans only while a profiler is on: the
traced periods."""

SPAN = "dwavehmc.anchor"


def read(ctx):
    from dwavehmc_tpu_torch.utils import profiling

    rec = getattr(profiling, "SPANS", {}).get(SPAN)
    if not rec or ctx.traced_traj == 0:
        return None
    return 1e3 * rec[1] / ctx.traced_traj
