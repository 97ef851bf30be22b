"""Device milliseconds of the eigh, cholesky and triangular-solve families
(the exact anchor's half-dimension eigh and its CholeskyQR) over the traced
chain-trajectories."""

FAMILIES = ("eigh", "cholesky", "triangular solve")


def read(ctx):
    t = ctx.trace
    if t is None or ctx.traced_traj == 0:
        return None
    s = sum(t.families.get(f, 0.0) for f in FAMILIES)
    return 1e3 * s / ctx.traced_traj if s > 0 else None
