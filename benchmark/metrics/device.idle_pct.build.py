"""Share of the traced window in which nothing ran on the device:
1 - (union of the device's activity intervals) / window, in %."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return (1 - run.trace["busy_s"] / run.trace["window_s"]) * 100
