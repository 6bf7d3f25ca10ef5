"""Frozen tokenizer and analyzer of the reference.

The port's documented word model (paper §5.1.3, §5.2): a document splits into
alternating word and separator tokens, a single blank between two words is
implicit (spaceless model); the positional index takes the tokens as they
are, the word index case-folds them and drops the 20 most common English
words.  Copied, not imported, so the reference never shares code with the
program it judges.
"""

from __future__ import annotations

import re

STOPWORDS = frozenset({
    "the", "of", "and", "a", "to", "in", "is", "you", "that", "it",
    "he", "was", "for", "on", "are", "as", "with", "his", "they", "i",
})

_TOKEN_RE = re.compile(r"[A-Za-z0-9]+|[^A-Za-z0-9]+")
_WORD_RE = re.compile(r"[A-Za-z0-9]")


def tokenize(doc: str) -> list[str]:
    """Word and separator tokens of ``doc``, single blanks dropped."""
    return [t for t in _TOKEN_RE.findall(doc) if t != " "]


def word_term(tok: str) -> str | None:
    """The word index's term for one token: case-folded, or None for a
    separator or a stop word."""
    if not _WORD_RE.match(tok):
        return None
    w = tok.lower()
    return None if w in STOPWORDS else w
