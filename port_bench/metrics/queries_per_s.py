"""queries_per_s (end to end, host clock): every query answered in the
measured window over the window's seconds (closed loop, one client)."""


def read(run):
    return run.window_queries / run.window_s if run.window_s > 0 else None
