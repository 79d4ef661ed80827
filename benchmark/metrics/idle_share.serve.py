"""Share of the traced serving window in which no operation ran on the
device, in %."""


def read(run):
    busy = run.recorded.busy_s()
    if busy <= 0 or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / run.window_s)
