"""device_us_per_window (kernels): the union of the kernels' time on the card
over the traced batches (``torch.profiler``; copies and fills left out) over
the windows they swept, in microseconds."""


def read(run):
    t = run.trace
    if not t or t.get("kernel_s", 0) <= 0 or not t.get("windows"):
        return None
    return 1e6 * t["kernel_s"] / t["windows"]
