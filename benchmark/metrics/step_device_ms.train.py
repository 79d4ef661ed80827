"""Device ms a training step: the union of the device's activity
intervals in the traced window, over the window's steps."""


def read(run):
    steps = run.counts.get("steps")
    busy = run.recorded.busy_s()
    if not steps or busy <= 0:
        return None
    return 1e3 * busy / steps
