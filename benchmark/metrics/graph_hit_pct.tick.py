"""graph_hit_pct.tick: the share of the window's ticks whose live refresh
replayed the engine's CUDA graph, %: the ``processor.tick`` spans starting
in the window whose ``live.refresh`` counted ``graph`` above 0, over all
of them. A program whose refreshes in the window count no ``graph`` (one
that has no such graph) gives nothing to read."""

from drfbench import spans

#: the span whose count says whether a tick replayed the graph
REFRESH = "live.refresh"


def read(run):
    ticks = spans.ticks(run)
    if ticks is None or not any("graph" in s.counts for t in ticks
                                for s in t.below if s.name == REFRESH):
        return None
    hit = sum(t.counted(REFRESH, "graph") > 0 for t in ticks)
    return 100.0 * hit / len(ticks)
