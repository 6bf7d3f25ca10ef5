"""The reference and the program's session on the CPU (``probe="torch"``)
agree on every query kind the mixes send, on tiny collections of each
configuration, and on edge cases of the documented semantics.

A run's texts are its configuration's (``text_seed``); here each
configuration is also built over other texts, so that the agreement is shown
on more than one collection's shapes."""

import numpy as np
import pytest
from conftest import ROOT, small_cell

from pbench import collection
from pbench.reference import Reference, RefIndex
from pbench.traffic import Query, Traffic

CELLS = ["wiki-repair-fused.paper-mix", "wiki-vbyte-dense.paper-mix"]
EDGES = [("word", ("The",)), ("word", ("zzzz",)), ("and", ("zzzz", "ba")),
         ("phrase", ("zzzz", "ba")), ("word", ("to",))]


TEXT_SEEDS = [0, 1, 2]


@pytest.fixture(scope="module", params=[(c, t) for c in CELLS for t in TEXT_SEEDS],
                ids=lambda p: f"{p[0]}-text{p[1]}")
def deployed(request):
    from pbench.program import Deployment

    workload, text_seed = request.param
    cell = small_cell(workload)
    docs = collection.generate(11, **dict(cell.config["collection"], text_seed=text_seed))
    docs[0] = "The " + docs[0] + ", to be."  # a capital, a separator and stop words
    ref = RefIndex(docs)
    return cell, ref, Deployment(ROOT, cell.config, docs, "cpu")


@pytest.mark.parametrize("kind", ["word", "and", "phrase"])
def test_paper_mix_kind(deployed, kind):
    cell, ref, dep = deployed
    queries = [q for i in range(3) for q in Traffic(cell.mix, ref.tokens, 5).batch(i)
               if q.kind == kind]
    got = dep.execute([q.text for q in queries])
    want = Reference(ref)
    assert sum(len(want.answer(q)) > 0 for q in queries) > len(queries) // 10
    for q, a in zip(queries, got):
        assert np.array_equal(np.asarray(a, dtype=np.int64), want.answer(q)), q.text


@pytest.mark.parametrize("kind,terms", EDGES)
def test_edge(deployed, kind, terms):
    _, ref, dep = deployed
    text = '"' + " ".join(terms) + '"' if kind == "phrase" else " ".join(terms)
    (got,) = dep.execute([text])
    assert np.array_equal(np.asarray(got, dtype=np.int64),
                          Reference(ref).answer(Query(kind, terms, text)))


def test_separator_phrase(deployed):
    """Phrases next to a separator token (``, ``), over one (``.``), and one
    that would span two documents: the reference's stream matches the
    program's."""
    _, ref, dep = deployed
    assert ref.tokens[0][-4:] == [", ", "to", "be", "."]
    for terms in (("to", "be"), ("to", "be", "."), (".", ref.tokens[1][0]),
                  (ref.tokens[0][-5], "to")):
        text = '"' + " ".join(terms) + '"'
        (got,) = dep.execute([text])
        want = Reference(ref).answer(Query("phrase", terms, text))
        assert np.array_equal(np.asarray(got, dtype=np.int64), want), text
