"""Training data pipelines (deterministic, seedable, host-side numpy).

* ``lm_batches``      — token stream from a (synthetic) document collection,
  packed into (batch, seq_len) next-token prediction examples;
* ``recsys_batches``  — synthetic click logs over the per-field vocabularies
  (Criteo-style) or item sequences (SASRec) or user/item pairs (two-tower);
* ``graph`` utilities live in ``repro.data.graphs`` (incl. the fanout
  neighbor sampler required by minibatch_lg).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..configs.base import LMConfig, RecsysConfig
from .collection import generate_collection
from .text import Vocabulary, tokenize


def lm_token_stream(n_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """Tokens from a repetitive synthetic collection, hashed into vocab."""
    col = generate_collection(
        n_articles=8, versions_per_article=10,
        words_per_doc=max(50, n_tokens // 60), seed=seed)
    vocab = Vocabulary()
    toks: list[int] = []
    for doc in col.docs:
        toks.extend(vocab.add(t) for t in tokenize(doc))
        if len(toks) >= n_tokens:
            break
    arr = np.asarray(toks[:n_tokens], dtype=np.int64)
    return arr % vocab_size


def lm_batches(cfg: LMConfig, batch: int, seq_len: int, seed: int = 0) -> Iterator[dict]:
    stream = lm_token_stream(batch * seq_len * 4 + 1, cfg.vocab_size, seed)
    n = len(stream) - 1
    rng = np.random.default_rng(seed)
    while True:
        starts = rng.integers(0, n - seq_len, batch)
        idx = starts[:, None] + np.arange(seq_len)[None, :]
        yield {
            "tokens": stream[idx].astype(np.int32),
            "targets": stream[idx + 1].astype(np.int32),
        }


def recsys_batches(cfg: RecsysConfig, batch: int, seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    if cfg.interaction in ("fm-2way", "cin"):
        sizes = np.asarray(cfg.field_vocab_sizes)
        # latent-factor ground truth so the loss is learnable
        w_true = rng.normal(size=(len(sizes),)) * 0.5
        while True:
            fields = (rng.random((batch, len(sizes))) * sizes).astype(np.int32)
            score = ((fields / sizes) * w_true).sum(1)
            labels = (score + rng.normal(size=batch) * 0.1 > w_true.sum() / 2).astype(np.float32)
            yield {"fields": fields, "labels": labels}
    elif cfg.interaction == "self-attn-seq":
        while True:
            hist = rng.integers(1, cfg.n_items, (batch, cfg.seq_len)).astype(np.int32)
            labels = np.roll(hist, -1, axis=1).astype(np.int32)
            negs = rng.integers(1, cfg.n_items, (batch, cfg.seq_len)).astype(np.int32)
            yield {"hist": hist, "target": labels[:, -1].copy(),
                   "labels": labels, "negatives": negs}
    elif cfg.interaction == "dot":
        while True:
            users = rng.integers(0, max(2, cfg.n_users), (batch, 16)).astype(np.int32)
            items = rng.integers(0, max(2, cfg.n_items), batch).astype(np.int32)
            labels = np.ones(batch, np.float32)  # in-batch softmax ignores this
            yield {"user_feats": users, "item_ids": items, "labels": labels}
    else:
        raise ValueError(cfg.interaction)
