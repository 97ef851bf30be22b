"""Chains whose float32 ``eigh`` in the exact anchor did not converge and
were redone in float64 (the program's ``ops/ph_eigh.GUARD["redone"]``),
as a share of the chains the anchor solved (guarded solves × chains) over
the window; the harness resets the counter at the window's start.  A
program without the count reads as no value."""


def read(ctx):
    guard = ctx.counters.get("ph_guard") or {}
    if ctx.traced_traj == 0 or not guard.get("solves") or (
            "redone" not in guard):
        return None
    return 100.0 * guard["redone"] / (guard["solves"] * ctx.cfg.n_chains)
