"""queries_per_s.dense (serving.session, host clock): ``queries_per_s`` as a
per-layer reading in the cells where the host's noise is too wide for its
bound: every query answered in the measured window over the window's
seconds (closed loop, one client)."""


def read(run):
    return run.window_queries / run.window_s if run.window_s > 0 else None
