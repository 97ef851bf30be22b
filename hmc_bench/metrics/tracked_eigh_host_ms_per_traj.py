"""Host milliseconds inside the program's ``dwavehmc.tracked_eigh`` spans
(each tracked eigensolve of the leapfrog: K1, K5, the GEMMs and
Newton–Schulz steps) over the traced chain-trajectories.  The program's
``utils/profiling.SPANS`` records spans only while a profiler is on: the
traced periods."""

SPAN = "dwavehmc.tracked_eigh"


def read(ctx):
    from dwavehmc_tpu_torch.utils import profiling

    rec = getattr(profiling, "SPANS", {}).get(SPAN)
    if not rec or ctx.traced_traj == 0:
        return None
    return 1e3 * rec[1] / ctx.traced_traj
