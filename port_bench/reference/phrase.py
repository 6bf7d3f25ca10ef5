"""Phrase query ``"t1 t2 ..."``: the sorted stream offsets at which ``t1``
starts an occurrence of the whole phrase (token ``j`` at offset + j), on the
tokens as they are (no case folding, no stop words dropped)."""

import numpy as np


def answer(ref, terms):
    starts = ref.positions_of(terms[0])
    for j, t in enumerate(terms[1:], start=1):
        if len(starts) == 0:
            break
        starts = np.intersect1d(starts, ref.positions_of(t) - j, assume_unique=True)
    return starts
