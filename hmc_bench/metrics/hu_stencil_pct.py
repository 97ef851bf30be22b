"""The share, in percent, of the program's float32 IEEE products by the
BdG Hamiltonian (W = H·U in T = U†(HU)) over the window that ran as its
sparse kernel K6: the program's ``ops/kernels.LAUNCHES["bdg_hop"]`` over
those plus the products it left dense (``LAUNCHES["hu_dense"]``), counts
the harness resets at the window's start.  A program without those counts,
or a window without such a product, reads as no value."""


def read(ctx):
    launches = ctx.counters.get("launches") or {}
    if ctx.traced_traj == 0 or "bdg_hop" not in launches or (
            "hu_dense" not in launches):
        return None
    total = launches["bdg_hop"] + launches["hu_dense"]
    if total == 0:
        return None
    return 100.0 * launches["bdg_hop"] / total
