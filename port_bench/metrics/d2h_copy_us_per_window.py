"""d2h_copy_us_per_window (serving.engine): the union of the device-to-host
copies' time on the card over the traced batches (``torch.profiler``: the
copies by which the engine brings each window's results back) over the
windows they swept, in microseconds."""


def read(run):
    t = run.trace
    if not t or t.get("d2h_s", 0) <= 0 or not t.get("windows"):
        return None
    return 1e6 * t["d2h_s"] / t["windows"]
