"""Text analysis chain: tokenize → case-fold → stopword-drop → stem.

The analyzer is the single place where raw document text (and raw query
terms) become index terms for the word-level (non-positional) indexes.
The same chain runs at build time and at query time — an index built with
one analyzer answers queries analyzed with the same chain, and the
on-disk artifact pins the configuration so ``open_index`` refuses a
mismatched query-time analyzer instead of silently returning wrong
rankings (a stemmed index probed with raw terms misses every variant).

The default chain reproduces the paper's §5.1.3 setup exactly (case
folding, top-20 stopwords removed, no stemming), so indexes built without
naming an analyzer are byte-identical to the historical build path.

The positional indexes are deliberately *not* analyzed: the paper's §5.2
positional/self-index setting indexes the text as-is (words and
separators), and phrase offsets must agree across families.  Analysis is
a word-space concern only.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..data.text import STOPWORDS, is_word_token, tokenize

# ----------------------------------------------------------------------
# stemming: a small deterministic suffix stripper.  Not a linguistic
# stemmer — the property that matters is that build and query apply the
# exact same deterministic map, so "serving"/"serves"/"served" land on
# one index term.  Longest suffix wins; a stem keeps >= 3 characters.
_STEM_SUFFIXES = ("ingly", "edly", "ings", "ies", "ing", "ed", "es", "ly", "s")
_MIN_STEM = 3


def stem_word(w: str) -> str:
    """Strip one inflectional suffix (longest match, stem >= 3 chars)."""
    for suf in _STEM_SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= _MIN_STEM:
            stem = w[: -len(suf)]
            return stem + "y" if suf == "ies" else stem
    return w


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Analyzer:
    """One configuration of the analysis chain.

    Frozen and hashable: the tuple of flags *is* the identity that gets
    pinned into artifact manifests, writer manifests, and plan-cache
    keys.  ``normalize`` maps one token to its index term or ``None``
    (separator, stopword); ``terms``/``doc_terms`` run whole strings.
    """

    case_fold: bool = True
    drop_stopwords: bool = True
    stem: bool = False

    def normalize(self, tok: str) -> str | None:
        """Index term for one token, or None if the token is dropped."""
        if not is_word_token(tok):
            return None
        w = tok.lower() if self.case_fold else tok
        if self.drop_stopwords and w in STOPWORDS:
            return None
        if self.stem:
            w = stem_word(w)
        return w

    def doc_terms(self, doc: str) -> list[str]:
        """Analyzed term sequence of a document (build-time path)."""
        out = []
        for tok in tokenize(doc):
            w = self.normalize(tok)
            if w is not None:
                out.append(w)
        return out

    def query_terms(self, terms) -> tuple[str, ...]:
        """Analyze already-split query terms (query-time path).  Terms the
        chain drops (stopwords, pure separators) vanish — callers decide
        whether an all-dropped query is an error."""
        out = []
        for t in terms:
            w = self.normalize(t)
            if w is not None:
                out.append(w)
        return tuple(out)

    # -- identity / persistence ----------------------------------------
    def config(self) -> dict:
        """JSON-safe configuration dict (pinned into manifests)."""
        return {"case_fold": self.case_fold,
                "drop_stopwords": self.drop_stopwords, "stem": self.stem}

    def signature(self) -> tuple:
        """Hashable identity for cache keys."""
        return (self.case_fold, self.drop_stopwords, self.stem)

    @classmethod
    def from_config(cls, cfg: dict | None) -> "Analyzer":
        """Inverse of :meth:`config`; ``None`` means the default chain."""
        if cfg is None:
            return cls()
        return cls(case_fold=bool(cfg.get("case_fold", True)),
                   drop_stopwords=bool(cfg.get("drop_stopwords", True)),
                   stem=bool(cfg.get("stem", False)))


DEFAULT_ANALYZER = Analyzer()

# named presets — what --analyzer on the serve CLI selects from
ANALYZERS: dict[str, Analyzer] = {
    "default": DEFAULT_ANALYZER,
    "raw": Analyzer(case_fold=False, drop_stopwords=False, stem=False),
    "stemmed": Analyzer(case_fold=True, drop_stopwords=True, stem=True),
}


def analyzer_names() -> list[str]:
    return sorted(ANALYZERS)


def get_analyzer(spec=None) -> Analyzer:
    """Resolve a preset name / config dict / instance / None to an Analyzer."""
    if spec is None:
        return DEFAULT_ANALYZER
    if isinstance(spec, Analyzer):
        return spec
    if isinstance(spec, dict):
        return Analyzer.from_config(spec)
    if isinstance(spec, str):
        try:
            return ANALYZERS[spec]
        except KeyError:
            raise ValueError(
                f"unknown analyzer {spec!r}; choose from {analyzer_names()}")
    raise ValueError(f"cannot resolve analyzer from {spec!r}")
