"""AND query ``w1 w2 ...``: the sorted ids of the documents that hold every
term; any term that no document holds (or that the analyzer drops) empties
the answer."""

from functools import reduce

import numpy as np


def answer(ref, terms):
    lists = [ref.docs_of(t) for t in terms]
    if any(len(x) == 0 for x in lists):
        return np.zeros(0, dtype=np.int64)
    return reduce(lambda a, b: np.intersect1d(a, b, assume_unique=True), lists)
