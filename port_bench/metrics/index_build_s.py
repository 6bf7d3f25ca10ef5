"""index_build_s (core build): the benchmark's span around
``NonPositionalIndex.build`` and ``PositionalIndex.build``."""


def read(run):
    return run.spans.get("index_build_s")
