"""Device milliseconds of the matmul family (cuBLAS and CUTLASS GEMMs:
the tracked rotations' products and the PH anchor's) over the traced
chain-trajectories."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.traced_traj == 0 or "matmul" not in t.families:
        return None
    return 1e3 * t.families["matmul"] / ctx.traced_traj
