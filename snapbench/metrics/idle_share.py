"""1 minus the union of the device's operation intervals over the traced
window (the profiler steps of the traced batches)."""


def read(run):
    tr = run["trace"]
    if not (tr["complete"] and tr["busy_s"] > 0 and tr["window_s"] > 0):
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
