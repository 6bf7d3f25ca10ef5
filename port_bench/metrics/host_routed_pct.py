"""host_routed_pct (serving.session): the share of the window's queries that
the session plans onto the host route (``Session.plan(q).route``)."""


def read(run):
    q = run.counters.get("queries", 0)
    return 100.0 * run.counters["host_routed"] / q if q else None
