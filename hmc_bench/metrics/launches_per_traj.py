"""Device kernels launched in the traced window over the chain-trajectories
of its periods."""


def read(ctx):
    if ctx.trace is None or ctx.traced_traj == 0 or ctx.trace.kernels == 0:
        return None
    return ctx.trace.kernels / ctx.traced_traj
