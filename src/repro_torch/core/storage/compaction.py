"""Background-compaction bookkeeping: the handle a caller watches.

:meth:`repro_torch.core.writer.IndexWriter.compact_async` builds the merged
segment on a worker thread and atomically swaps it into the writer
manifest; the returned :class:`CompactionHandle` is the observable half —
``done`` to poll, :meth:`wait` to join (re-raising the worker's exception
on failure), ``result`` for the merged :class:`~repro_torch.core.writer.SegmentMeta`.

The handle never exposes the thread directly: the only interaction points
are the ones that cannot corrupt the writer (poll, join, read result).
"""

from __future__ import annotations

import threading


class CompactionError(RuntimeError):
    """Background compaction failed; the original segment set is intact."""


class CompactionHandle:
    """One in-flight (or finished) background compaction."""

    def __init__(self, target, name: str = "compaction"):
        self._finished = threading.Event()
        self._result = None
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(target,),
                                        name=name, daemon=True)

    def _run(self, target) -> None:
        try:
            self._result = target()
        except BaseException as e:  # surfaced on wait()/result
            self._error = e
        finally:
            self._finished.set()

    def start(self) -> "CompactionHandle":
        self._thread.start()
        return self

    @property
    def done(self) -> bool:
        """True once the worker finished — swap complete or failed."""
        return self._finished.is_set()

    @property
    def failed(self) -> bool:
        return self._finished.is_set() and self._error is not None

    def wait(self, timeout: float | None = None):
        """Join the compaction: returns the merged segment's metadata, or
        re-raises the worker's failure wrapped in :class:`CompactionError`
        (the pre-compaction segment set is untouched on failure)."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"compaction still running after {timeout}s — poll .done "
                f"or wait() without a timeout")
        if self._error is not None:
            raise CompactionError(
                f"background compaction failed: {self._error}"
            ) from self._error
        return self._result

    @property
    def result(self):
        """The merged segment's metadata (None while running / on failure)."""
        return self._result
