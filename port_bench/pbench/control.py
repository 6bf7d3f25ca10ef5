"""The control of the check: the reference put in the program's place with
the configuration's guarantee broken, which the comparison has to fail.

The configuration states exact answers for lists of any length.  The step
that would tempt a later change is to sweep one candidate window and stop:
``CUT`` postings a list (64 entries of 32), the first window's worth.  The
control answers every query from lists cut so.
"""

from __future__ import annotations

from .reference import Reference

#: postings a list keeps in the control (one window: 64 entries x 32 lanes)
CUT = 64 * 32


class _CutIndex:
    def __init__(self, ref, cut: int):
        self._ref, self._cut = ref, cut

    def docs_of(self, word):
        return self._ref.docs_of(word)[: self._cut]

    def positions_of(self, token):
        return self._ref.positions_of(token)[: self._cut]


def control_answers(ref, batches, cut: int = CUT) -> list[list]:
    """The control's answers to each query of each batch."""
    control = Reference(_CutIndex(ref, cut))
    return [[control.answer(q) for q in b] for b in batches]
