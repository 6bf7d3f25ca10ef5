"""session_build_s (device layout): the benchmark's span around
``Session.build`` (both servers' device layouts)."""


def read(run):
    return run.spans.get("session_build_s")
