"""index_device_pct (device layout): both servers' ``device_bytes()`` (the
posting layouts; rank arrays and document starts left out) over the
collection's bytes, x 100."""


def read(run):
    return 100.0 * run.index_device_bytes / run.collection_bytes if run.collection_bytes else None
