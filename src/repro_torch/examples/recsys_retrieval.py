"""Recsys retrieval with an inverted-index candidate pre-filter — where the
paper's technique plugs directly into a neural serving stack.

Items carry categorical tags; the tag->item posting lists are stored
Re-Pair-compressed (the paper's index).  A query first pre-filters
candidates by tag (compressed AND query on the host), then the two-tower
model scores only the filtered set on ``--device`` (``cuda`` unless the
caller asks for ``cpu``; on a card its lookups launch ``embedding_bag``) —
vs brute-force scoring of the whole catalog.

    PYTHONPATH=src python -m repro_torch.examples.recsys_retrieval [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.device import resolve_device
from ..core.intersect import repair_intersect_multi
from ..core.repair import RePairStore
from ..models import recsys
from ..models import steps as steps_mod


def retrieval_config():
    """The reduced two-tower model over a 5,000-item catalog."""
    cfg = get_config("two-tower-retrieval").reduced()
    return dataclasses.replace(cfg, n_items=5000, n_users=1000)


def main(argv=None, params=None) -> dict:
    """``params`` (a two-tower model on the device) replaces the seeded
    weights; returns the candidates, the top-5 and the two scorings."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    cfg = retrieval_config()
    n_items, n_tags = cfg.n_items, 40
    if params is None:
        params = steps_mod.init_model_params(cfg, torch.Generator(dev).manual_seed(0), dev)

    # tag -> item posting lists (clustered: versioned-catalog-like)
    tags_per_item = [
        set(rng.choice(n_tags, size=int(rng.integers(1, 4)), replace=False).tolist())
        | {int(i // (n_items // 8) % n_tags)}
        for i in range(n_items)
    ]
    lists = [np.asarray(sorted(i for i in range(n_items) if t in tags_per_item[i]),
                        dtype=np.int64) for t in range(n_tags)]
    store = RePairStore.build(lists, variant="skip")
    print(f"tag index: {n_tags} tags over {n_items} items, "
          f"{store.size_in_bits/8/1024:.1f} KiB compressed")

    @torch.no_grad()
    def serve(u, c):
        return recsys.tt_retrieval(cfg, params, u, c).cpu().numpy()  # waits for the device

    user = torch.as_tensor(rng.integers(0, cfg.n_users, (1, 16)), dtype=torch.int32, device=dev)

    # brute force: score everything
    all_items = torch.arange(n_items, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    scores_all = serve(user, all_items)[0]
    brute_ms = 1e3 * (time.perf_counter() - t0)

    # pre-filtered: items with both required tags (compressed intersection)
    want = [2, 9]
    cand = repair_intersect_multi(store, want)
    t0 = time.perf_counter()
    scores = serve(user, torch.as_tensor(cand, dtype=torch.int32, device=dev))[0]
    filt_ms = 1e3 * (time.perf_counter() - t0)
    top = cand[np.argsort(-scores)[:5]]
    print(f"tags {want}: {len(cand)}/{n_items} candidates after index pre-filter")
    print(f"top-5 items {top.tolist()}")
    # consistency: the filtered top-5 equals brute-force top-5 restricted to the filter
    mask = np.zeros(n_items, bool)
    mask[cand] = True
    ref_top = np.argsort(-np.where(mask, scores_all, -np.inf))[:5]
    if set(top.tolist()) != set(ref_top.tolist()):
        raise AssertionError(f"pre-filtered top-5 {top.tolist()} != brute-force top-5 "
                             f"{ref_top.tolist()} restricted to the filter")
    print(f"score-all={brute_ms:.1f}ms vs prefiltered={filt_ms:.1f}ms (identical top-k)")
    return {"candidates": cand, "top5": top, "scores": scores, "scores_all": scores_all,
            "brute_ms": brute_ms, "filtered_ms": filt_ms}


if __name__ == "__main__":
    main()
