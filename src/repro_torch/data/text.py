"""Word tokenization + vocabulary (spaceless-words model, paper §5.2/[47]).

Documents are strings.  ``tokenize`` splits them into alternating word and
separator tokens; under the spaceless model a single blank between two words
is implicit and not emitted.  The positional indexes and the word-oriented
self-indexes (WCSA/WSLP) both consume the resulting integer sequences, so
phrase offsets agree across index families.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# 20 most common English stopwords (paper §5.1.3 removes the top 20)
STOPWORDS = {
    "the", "of", "and", "a", "to", "in", "is", "you", "that", "it",
    "he", "was", "for", "on", "are", "as", "with", "his", "they", "i",
}

_TOKEN_RE = re.compile(r"[A-Za-z0-9]+|[^A-Za-z0-9]+")


def tokenize(doc: str, spaceless: bool = True) -> list[str]:
    """Split into word / separator tokens; single blanks dropped if spaceless."""
    toks = _TOKEN_RE.findall(doc)
    if spaceless:
        toks = [t for t in toks if t != " "]
    return toks


def detokenize(tokens: list[str]) -> str:
    """Inverse of tokenize under the spaceless model."""
    out: list[str] = []
    prev_word = False
    for t in tokens:
        is_word = bool(re.match(r"[A-Za-z0-9]", t))
        if is_word and prev_word:
            out.append(" ")
        out.append(t)
        prev_word = is_word
    return "".join(out)


@dataclass
class Vocabulary:
    """Bidirectional token <-> id mapping."""

    token_to_id: dict[str, int] = field(default_factory=dict)
    id_to_token: list[str] = field(default_factory=list)

    def add(self, tok: str) -> int:
        i = self.token_to_id.get(tok)
        if i is None:
            i = len(self.id_to_token)
            self.token_to_id[tok] = i
            self.id_to_token.append(tok)
        return i

    def get(self, tok: str) -> int | None:
        return self.token_to_id.get(tok)

    def __len__(self) -> int:
        return len(self.id_to_token)

    def encode_doc(self, doc: str, spaceless: bool = True) -> np.ndarray:
        return np.asarray([self.add(t) for t in tokenize(doc, spaceless)], dtype=np.int64)

    def size_in_bits(self) -> int:
        return sum(8 * (len(t) + 1) for t in self.id_to_token)


def normalize_word(w: str, case_fold: bool = True) -> str:
    return w.lower() if case_fold else w


def is_word_token(tok: str) -> bool:
    return bool(re.match(r"[A-Za-z0-9]", tok))
