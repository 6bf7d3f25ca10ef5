"""The control (the reference with every list cut to one window's
postings, ``pbench.control``) fails the check, and the reference itself
passes it, at a size where lists outgrow a window."""

import pytest
from conftest import small_cell

from pbench import collection
from pbench.control import control_answers
from pbench.reference import Reference, RefIndex
from pbench.runner import compare
from pbench.traffic import Traffic


@pytest.fixture(scope="module")
def batches():
    cell = small_cell("wiki-repair-fused.paper-mix", batch=256, n_articles=6, versions=20,
                      words=400)
    ref = RefIndex(collection.generate(3, **cell.config["collection"]))
    traffic = Traffic(cell.mix, ref.tokens, 3)
    return ref, [traffic.batch(i) for i in range(1, 4)]


def test_control_fails(batches):
    ref, bs = batches
    compared, mismatched, _ = compare(bs, control_answers(ref, bs), Reference(ref))
    assert compared == 3 * 256 and mismatched > 0


def test_reference_passes(batches):
    ref, bs = batches
    want = Reference(ref)
    compared, mismatched, nonempty = compare(bs, [[want.answer(q) for q in b] for b in bs],
                                             Reference(ref))
    assert mismatched == 0 and nonempty > compared // 2
