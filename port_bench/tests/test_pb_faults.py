"""The check catches a broken timed path: a whole run on the CPU with a fault
planted underneath the session has ``correct`` false, once for each fault a
query cell can have (an answer altered where the device route produces it;
half of the batch left out)."""

import time

import numpy as np
import pytest
from conftest import ROOT, small_cell

from pbench.runner import run_cell


def _alter_device_answer(monkeypatch):
    from repro_torch.serving.engine import BatchedServer

    collect = BatchedServer._collect

    def altered(self, *a, **kw):
        out = collect(self, *a, **kw)
        for i, r in enumerate(out):
            if len(r):
                out[i] = r[:-1]  # one posting dropped, where the sweep collects it
                break
        return out

    monkeypatch.setattr(BatchedServer, "_collect", altered)


def _half_the_batch(monkeypatch):
    from repro_torch.serving.session import Session

    execute = Session.execute

    def half(self, queries):
        out = execute(self, list(queries)[: len(queries) // 2])
        return out + [np.zeros(0, dtype=np.int64)] * (len(queries) - len(out))

    monkeypatch.setattr(Session, "execute", half)


@pytest.mark.parametrize("fault", [_alter_device_answer, _half_the_batch],
                         ids=["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("workload", ["wiki-repair-fused.paper-mix",
                                      "wiki-vbyte-dense.paper-mix"])
def test_fault_is_not_correct(monkeypatch, fault, workload):
    from pbench.program import import_program

    import_program(ROOT)
    fault(monkeypatch)
    cell = small_cell(workload, batch=96, n_articles=2, versions=3, words=40)
    result, lines = run_cell(ROOT, cell, 99, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] is False
    assert result["checks"]["mismatched_answers"]["value"] > 0
    assert lines[-1].startswith("check mismatched_answers:")
