"""device_idle_pct (device): 1 - the union of device activity over the
traced batches' wall time, x 100 (``torch.profiler``)."""


def read(run):
    t = run.trace
    if not t or t.get("busy_s", 0) <= 0 or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
