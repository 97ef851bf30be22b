"""The share, in percent, of the traced cheap sweeps that the program
replayed as one CUDA graph: calls of its ``dwavehmc.cheap_graph`` span over
those plus the eager cheap accepts (``dwavehmc.accept_cheap``).  The
program's ``utils/profiling.SPANS`` records spans only while a profiler is
on: the traced periods.  A program without the graph runner
(``parallel/cheap_graph.py``), or traced periods with no cheap sweep, read
as no value."""

import importlib.util

GRAPH = "dwavehmc.cheap_graph"
EAGER = "dwavehmc.accept_cheap"
RUNNER = "dwavehmc_tpu_torch.parallel.cheap_graph"


def read(ctx):
    from dwavehmc_tpu_torch.utils import profiling

    if importlib.util.find_spec(RUNNER) is None or ctx.traced_traj == 0:
        return None
    spans = getattr(profiling, "SPANS", {})
    graph = spans.get(GRAPH, [0])[0]
    eager = spans.get(EAGER, [0])[0]
    if graph + eager == 0:
        return None
    return 100.0 * graph / (graph + eager)
