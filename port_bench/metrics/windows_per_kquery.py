"""windows_per_kquery (serving.engine): candidate windows the servers swept
in the measured window (``BatchedServer.windows_swept``), per 1,000 queries."""


def read(run):
    q = run.counters.get("queries", 0)
    return 1000.0 * run.counters["windows"] / q if q else None
