"""Guarded PH solves that fell back to the full eigh, as a share of all
guarded solves over the window (the program's ``ops/ph_eigh.GUARD``, which
the harness resets at the window's start)."""


def read(ctx):
    guard = ctx.counters.get("ph_guard") or {}
    if ctx.traced_traj == 0 or not guard.get("solves"):
        return None
    return 100.0 * guard["fallbacks"] / guard["solves"]
