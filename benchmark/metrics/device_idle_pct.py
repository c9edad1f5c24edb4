"""100 minus the union of every device event's interval, as a share of
the traced window's wall time."""


def read(run):
    if run.trace is None or not run.trace.device_events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
