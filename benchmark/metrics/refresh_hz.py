"""refresh_hz: the live views delivered per second: the ticks of every
tab that began in the window and reached the tab's callback, over the
window's seconds."""


def read(run):
    ticks = run.latencies.get("tick")
    if not ticks or run.window_s <= 0:
        return None
    return len(ticks) / run.window_s
