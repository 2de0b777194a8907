"""Device time (kernels, copies, fills) over the traced window's steps,
per step (a bank here, a batch in ``query.device_ms``), from the
profiler, in ms."""


def read(run):
    if not run.trace or run.trace["device_s"] <= 0:
        return None
    return run.trace["device_s"] / run.trace["steps"] * 1e3
