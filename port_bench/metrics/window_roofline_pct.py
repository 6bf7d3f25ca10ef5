"""window_roofline_pct (kernels): the least time of the windows the traced
batches swept (``pbench.work``: each window's operations and bytes from its
own inputs, against the H100's published peaks) over the kernels' time on the
card in those batches (copies and fills left out), x 100."""


def read(run):
    t = run.trace
    if not t or t.get("kernel_s", 0) <= 0 or not t.get("windows"):
        return None
    least, windows = run.window_least_seconds()
    if windows != t["windows"] or least <= 0:
        return None
    return 100.0 * least / t["kernel_s"]
