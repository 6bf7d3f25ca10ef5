"""device_mem_pct (end to end): the bytes the deployment holds on the card
between batches, by the device's own count (``cudaMemGetInfo``, read by the
benchmark once the traced batches are done and the allocator's cache of
freed blocks is released, less the reading before the program started:
index layouts, rank arrays, loaded kernels, everything) over the
collection's bytes, x 100."""


def read(run):
    if run.device_held_bytes is None:
        return None
    return 100.0 * run.device_held_bytes / run.collection_bytes
