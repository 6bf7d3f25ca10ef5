"""setup_s (end to end, host clock): process start to the first timed batch
(collection, both index builds, the session, the query pool, one warm-up
batch, run twice)."""


def read(run):
    return run.setup_s
