"""The share, in percent, of the program's float32 IEEE Hermitian products
A†B (T = U†(HU) and Newton–Schulz's U†U) over the window that ran as its
lower-triangle kernel K7: the program's ``ops/kernels.LAUNCHES["herm_dag"]``
over those plus the products it left dense (``LAUNCHES["herm_dense"]``),
counts the harness resets at the window's start.  A program without those
counts, or a window without such a product, reads as no value."""


def read(ctx):
    launches = ctx.counters.get("launches") or {}
    if ctx.traced_traj == 0 or "herm_dag" not in launches or (
            "herm_dense" not in launches):
        return None
    total = launches["herm_dag"] + launches["herm_dense"]
    if total == 0:
        return None
    return 100.0 * launches["herm_dag"] / total
