"""ahead_pct.tick: the share of the window's samples that the live engine
read between ticks, %: the ``samples`` the program counts on its
``live.read`` spans inside ``processor.wait`` spans (a tab's pacing
interval, in which the engine ingests ahead of the next tick), over those
inside ``processor.wait`` and ``processor.tick`` spans, of the waits and
ticks that start in the window. A program that counts no samples on its
reads gives nothing to read."""

from drfbench import spans

#: the spans a read is inside of: one iteration of a tab's loop, its pacing
OUTER = ("processor.tick", "processor.wait")


def read(run):
    placed = spans._placed(run)
    if placed is None:
        return None
    got, off = placed
    t0, t1 = run.trace.t0, run.trace.t1
    by_id = {s.id: s for s in got}
    read_in = dict.fromkeys(OUTER, 0)
    for s in got:
        n = int(s.counts.get("samples", 0)) if s.name == spans.READ_SPAN else 0
        if not n or s.t1_ns is None:
            continue
        top = by_id.get(s.parent)
        while top is not None and top.name not in OUTER:
            top = by_id.get(top.parent)
        if top is not None and t0 <= top.t0_ns / 1e3 + off < t1:
            read_in[top.name] += n
    total = sum(read_in.values())
    return 100.0 * read_in["processor.wait"] / total if total else None
