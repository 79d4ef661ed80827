"""Device ms a served call: the union of the device's activity intervals
in the traced window, over the window's calls."""


def read(run):
    calls = run.counts.get("calls")
    busy = run.recorded.busy_s()
    if not calls or busy <= 0:
        return None
    return 1e3 * busy / calls
