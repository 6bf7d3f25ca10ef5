"""The general traffic generator: reads a mix file (``traffic/<mix>.json``)
and draws batches of queries from the run's seed and the collection's tokens.

A mix file holds:

* ``loop``: ``"closed"`` (one client, each batch sent when the last one is
  answered; the only loop the runner drives today);
* ``batch``: queries a batch;
* ``queries``: entries of ``kind`` (the reference file that answers them,
  ``reference/<kind>.py``), ``terms`` (a count, or ``[lo, hi]`` drawn
  uniformly), ``draw`` (where the terms come from, below), ``format`` (the
  query string, ``{terms}`` standing for the terms joined by blanks) and
  ``share`` (the entry's share of a batch; remainders go to the last
  entries).  A mix or an entry with any other key is refused.

Draws (the paper's query sets, §5): ``low_df`` / ``high_df`` a word of the
analyzed vocabulary whose document frequency is at most / above the median;
``vocabulary`` words drawn uniformly from it; ``text`` consecutive tokens from
a random position of a random document.

Batch ``i`` of a seed is always the same queries, whatever else was drawn.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .text import tokenize, word_term

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"
DRAWS = ("low_df", "high_df", "vocabulary", "text")
MIX_KEYS = {"about", "loop", "batch", "queries"}
ENTRY_KEYS = {"kind", "terms", "draw", "format", "share"}


@dataclass(frozen=True)
class Query:
    kind: str
    terms: tuple[str, ...]
    text: str


def load_mix(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    extra = set(mix) - MIX_KEYS | {k for e in mix["queries"] for k in set(e) - ENTRY_KEYS}
    if extra:
        raise ValueError(f"mix {name!r}: keys that nothing reads: {sorted(extra)}")
    if mix.get("loop") != "closed":
        raise ValueError(f"mix {name!r}: only closed-loop batches are driven, got "
                         f"{mix.get('loop')!r}")
    for e in mix["queries"]:
        if e["draw"] not in DRAWS:
            raise ValueError(f"mix {name!r}: unknown draw {e['draw']!r}; use one of {DRAWS}")
    return mix


def entry_counts(mix: dict) -> list[int]:
    """Queries of each entry in a batch: the shares of ``batch``, rounded
    down, the remainder one each to the last entries."""
    shares = [float(e["share"]) for e in mix["queries"]]
    n = int(mix["batch"])
    counts = [int(n * s / sum(shares)) for s in shares]
    for j in range(n - sum(counts)):
        counts[len(counts) - 1 - j] += 1
    return counts


def tokens_of(docs: list[str]) -> list[list[str]]:
    """Each document's tokens, as the reference's tokenizer splits them."""
    return [tokenize(d) for d in docs]


class Traffic:
    """Batches of ``mix`` over a collection given as each document's tokens
    (``tokens_of``)."""

    def __init__(self, mix: dict, tokens: list[list[str]], seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.counts = entry_counts(mix)
        self.tokens = tokens
        counts: dict[str, int] = {}
        for toks in tokens:
            for term in dict.fromkeys(t for t in map(word_term, toks) if t is not None):
                counts[term] = counts.get(term, 0) + 1
        vocab = list(counts)  # the analyzed vocabulary, in order of first appearance
        df = np.asarray([counts[t] for t in vocab])
        med = float(np.median(df))
        self.words = {"vocabulary": vocab,
                      "low_df": [t for t, f in zip(vocab, df) if f <= med],
                      "high_df": [t for t, f in zip(vocab, df) if f > med]}

    def _terms(self, e: dict, rng: np.random.Generator) -> tuple[str, ...]:
        n = e["terms"]
        n = int(rng.integers(n[0], n[1] + 1)) if isinstance(n, list) else int(n)
        if e["draw"] == "text":
            while True:
                toks = self.tokens[int(rng.integers(len(self.tokens)))]
                if len(toks) >= n:
                    i = int(rng.integers(0, len(toks) - n + 1))
                    return tuple(toks[i:i + n])
        words = self.words[e["draw"]]
        return tuple(words[int(rng.integers(len(words)))] for _ in range(n))

    def batch(self, i: int) -> list[Query]:
        rng = np.random.default_rng([self.seed, int(i)])
        out = []
        for e, count in zip(self.mix["queries"], self.counts):
            for _ in range(count):
                # the terms as the query string carries them (a separator
                # token with a blank in it splits, as the program parses it)
                terms = tuple(" ".join(self._terms(e, rng)).split())
                out.append(Query(e["kind"], terms,
                                 e["format"].replace("{terms}", " ".join(terms))))
        return [out[j] for j in rng.permutation(len(out))]
