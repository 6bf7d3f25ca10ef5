"""Word query ``w``: the sorted ids of the documents whose analyzed words
hold ``w`` analyzed the same way.  A word the analyzer drops (a stop word, a
separator) or that no document holds answers nothing."""


def answer(ref, terms):
    (w,) = terms
    return ref.docs_of(w)
