"""One rank's part of an LM's compute on a ``("data", "model")`` mesh (or
``("pod", "data", "model")``): the plan that ``spmd.make_sharded_train_step``
runs for the LM family, as the reference's GSPMD splits its
``jit(train_step)`` with ``act_spec = P(dp, "model", None)``.

The layout of every weight is read from its placement (the reference's
specs, :mod:`.specs`); the compute follows it:

* **residual stream** — sequence-parallel: a rank holds the T / m tokens of
  its model coordinate (m the model axis' size) of its data rows; norms run
  on that shard;
* **attention** — the rank computes whole heads: heads ``ceil(r h / m)`` to
  ``ceil((r + 1) h / m) - 1`` on model rank r (whole heads also where h / m
  is not whole), with the kv heads they read.  The normed stream is
  gathered along T before ``wq`` / ``wk`` / ``wv`` (column-parallel);
  ``wo`` (row-parallel) gives a partial sum, reduce-scattered along T.
  Where a rank's columns are not its shard of a weight (8 kv heads on 16
  ranks: half a kv head a shard; 24 heads on 16: 1.5 heads a shard), the
  layer gathers that weight over ``"model"`` and takes the columns of its
  heads; the backward reduce-scatters the gradient back into the shards.
  Where a rank's q heads do not share their kv heads evenly, k and v are
  repeated to one kv head a q head;
* **dense FFN / shared experts** — ``w_gate`` / ``w_up`` column-parallel,
  ``w_down`` row-parallel between the same gather and reduce-scatter; a
  width that the spec does not shard (it falls back to replication) runs
  whole on the rank's own tokens;
* **MoE** — expert-parallel with an all-gather dispatcher (exact in
  routing): each rank routes its own tokens with the whole router, gathers
  the tokens, gates and expert ids of its data rows along T, so that
  ``moe_dispatch`` sees the whole token groups (capacity and drops those
  of the unsharded step), fills the dispatch buffer of its experts only
  (its shard; ``ceil``-split experts of a replicated weight), and
  reduce-scatters each token's float32 sum along T.  The aux loss's choice
  counts are summed over the data and the model ranks;
* **embedding and head** — gathered whole over ``"model"`` (vocabulary rows
  or, where the vocabulary does not divide, ``d_model``) and applied to the
  rank's tokens: logits (B, T / m, V), log-softmax over whole rows as the
  unsharded loss does (at m = 1 the same arithmetic);
* **FSDP** — every dimension a spec shards over a data axis (``d_model`` on
  ``"data"`` past 2e9 parameters) is gathered per layer, inside the layer
  function (so a checkpointed layer gathers again in its recompute and
  saves nothing), and its gradient reduce-scattered back into the shard.

Every weight reaches the layers through ``tp.fetch``: the gradients land in
float32 shards (``sinks``), never in the parameters' ``.grad``.  The split
needs at least one head and one expert a model rank and T divisible by m.

Serving (``sharding.lm_serve``) reads the same plan through views without
gradient sinks (``tp.fetch_nograd``: the same per-layer gathers):

* **prefill** — :class:`RankView` with ``sinks=None``: the train step's
  layout, then each layer's k and v (the rank's kv heads over the gathered
  T) go through one all-to-all over ``"model"`` into the decode's cache
  layout, every kv head over the rank's T / m rows
  (:meth:`RankView.cache_rows`); a kv head that several ranks hold (fewer
  kv heads than model ranks) is sent by the first of them alone.  Only the
  last model rank holds the last position, so only it computes a logit;
* **decode** — :class:`DecodeView`: a row's token is whole on every model
  rank of its data rows (one token cannot be split along T); q, k and v of
  the rank's heads are gathered whole over ``"model"``
  (:meth:`DecodeView.decode_heads`), every rank attends over its own T
  slice of the cache for every head (``flash_decode_partial``), the ranks'
  partials are joined (``decode_split.combine_partials``), the rank's heads
  of the result go through its rows of ``wo``, and the row-parallel
  products (``wo``, ``w_down``, the experts) are all-reduced over
  ``"model"`` where the train step reduce-scatters them.  Only the rank
  whose slice holds a row's position writes that row's new k and v.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Shard

from ..configs.base import LMConfig
from ..kernels.flash_decode import ops as fd_ops
from . import decode_split, tp


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _owned(n: int, m: int, r: int) -> tuple[int, int]:
    """The range of ``n`` items (heads, experts) that model rank ``r`` of
    ``m`` computes: items ``ceil(r n / m)`` to ``ceil((r + 1) n / m) - 1``."""
    return _ceil_div(r * n, m), _ceil_div((r + 1) * n, m)


def head_plan(h: int, kh: int, m: int, r: int):
    """``(q range, kv range, expand)`` of model rank ``r``: its q heads, the
    kv heads they read and, where those q heads do not share their kv heads
    evenly, the kv head (within the range) of each q head; else None."""
    a, b = _owned(h, m, r)
    g = h // kh
    ka, kb = a // g, (b - 1) // g + 1
    counts = {sum(1 for q in range(a, b) if q // g == j) for j in range(ka, kb)}
    expand = None if len(counts) == 1 else [q // g - ka for q in range(a, b)]
    return (a, b), (ka, kb), expand


def _whole_head_plan(ranges: list, owned: list) -> tuple[int, list]:
    """``(width, index)``: the widest rank's piece, and where head j lies in
    the gathered pieces (from the rank in ``owned`` that holds it)."""
    width = max(b - a for a, b in ranges)
    return width, [j * width + h - ranges[j][0] for j, (a, b) in enumerate(owned)
                   for h in range(a, b)]


class LMSplit:
    """The plan of one rank: which gathers and which columns each weight
    takes, its heads and experts.  ``param_sh`` holds each parameter's
    DTensor placements on ``mesh``, ``shapes`` its whole shape."""

    def __init__(self, cfg: LMConfig, mesh, param_sh: dict, shapes: dict):
        names = tuple(mesh.mesh_dim_names)
        if "model" not in names:
            raise ValueError(f"mesh axes {names} have no 'model' axis to split an LM over")
        self.cfg, self.mesh, self.names = cfg, mesh, names
        #: None, or a callable that sees every weight operand a view fetches
        #: (the dry-run keeps those storages out of its saved-activation count)
        self.on_fetch = None
        self.groups = {a: mesh.get_group(a) for a in names}
        #: the ranks over which the MoE aux loss's choice counts are summed:
        #: every data and model rank (each holds other tokens of the batch)
        self.count_groups = [self.groups[a] for a in names]
        j = names.index("model")
        m, r = mesh.size(j), mesh.get_local_rank("model")
        self.m, self.r = m, r
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if h < m:
            raise ValueError(f"{cfg.name}: {h} heads on {m} model ranks; the split needs a "
                             f"head a rank")
        (a, b), (ka, kb), expand = head_plan(h, kh, m, r)
        self.heads = (b - a, kb - ka, expand)
        plans = [head_plan(h, kh, m, j) for j in range(m)]
        #: every model rank's q heads and kv heads, and the kv heads each sends
        #: in the prefill's all-to-all (the first rank that holds a kv head)
        self.q_ranges = [p[0] for p in plans]
        self.kv_ranges = [p[1] for p in plans]
        self.kv_owned, first = [], 0
        for ka_j, kb_j in self.kv_ranges:
            self.kv_owned.append((max(ka_j, first), max(kb_j, first)))
            first = max(first, kb_j)
        #: the decode's gather of whole heads: each rank's piece padded to
        #: ``width``, then head j taken from its owner's piece at ``index``
        self.whole_heads = {name: _whole_head_plan(ranges, owned) for name, ranges, owned in
                            (("q", self.q_ranges, self.q_ranges),
                             ("kv", self.kv_ranges, self.kv_owned))}
        self._index_on = {}
        want = {"wq": (1, a * hd, b * hd), "wk": (1, ka * hd, kb * hd),
                "wv": (1, ka * hd, kb * hd), "wo": (0, a * hd, b * hd)}
        self.experts = None
        if cfg.moe:
            e = cfg.moe.n_experts
            if e < m:
                raise ValueError(f"{cfg.name}: {e} experts on {m} model ranks; the split "
                                 f"needs an expert a rank")
            lo, hi = self.expert_range = _owned(e, m, r)
            self.experts = None if (lo, hi) == (0, e) else (lo, hi)
            want.update({k: (0, lo, hi) for k in ("w_gate", "w_up", "w_down")})
            self.shared_split = self._sharded_on_model(param_sh, "layers/ws_gate")
            self.ffn_split = True
        else:
            self.ffn_split = self._sharded_on_model(param_sh, "layers/w_gate")
            self.shared_split = False
        for name, (w_in, w_out) in (("w", ("w_gate", "w_up")), ("ws", ("ws_gate", "ws_up"))):
            if (name == "w" and not cfg.moe and self.ffn_split) or (
                    name == "ws" and self.shared_split):
                f = cfg.d_ff if name == "w" else cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
                lo, hi = f * r // m, f * (r + 1) // m
                want.update({w_in: (1, lo, hi), w_out: (1, lo, hi),
                             f"{name}_down": (0, lo, hi)})
        self.plans = {}
        for path, pl in param_sh.items():
            layer = path.startswith("layers/")
            name = path[len("layers/"):] if layer else path
            self.plans[path] = self._leaf_plan(pl, tuple(shapes[path]),
                                               want.get(name) if layer else None,
                                               1 if layer else 0)

    def _sharded_on_model(self, param_sh: dict, path: str) -> bool:
        pl = param_sh.get(path)
        return pl is not None and isinstance(pl[self.names.index("model")], Shard)

    def _leaf_plan(self, placements, shape: tuple, want, lead: int):
        """``(gathers, narrow)`` of one leaf (a layer's slice of a stacked
        leaf: ``lead`` = 1 drops the layer dimension): the data-axis gathers
        first, innermost axis first, then the model gather where the rank's
        range ``want`` = ``(dim, lo, hi)`` is not its shard (None: the whole
        weight); ``narrow`` = ``(dim, start, length)`` or None."""
        gathers, model_dim = [], None
        for j in reversed(range(len(self.names))):
            p = placements[j]
            if not isinstance(p, Shard):
                continue
            if self.names[j] == "model":
                model_dim = p.dim - lead
            else:
                gathers.append((p.dim - lead, self.groups[self.names[j]]))
        if want is None:
            if model_dim is not None:
                gathers.append((model_dim, self.groups["model"]))
            return tuple(gathers), None
        dim, lo, hi = want
        if model_dim is not None:
            n = shape[model_dim + lead] // self.m  # the specs shard only what divides
            if model_dim == dim and (lo, hi) == (self.r * n, (self.r + 1) * n):
                return tuple(gathers), None
            gathers.append((model_dim, self.groups["model"]))
        if (lo, hi) == (0, shape[dim + lead]):
            return tuple(gathers), None
        return tuple(gathers), (dim, lo, hi - lo)

    def view(self, local: dict, sinks: dict | None = None,
             anchor: torch.Tensor | None = None) -> "RankView":
        """The train step's view (``sinks`` and ``anchor``), or, without
        them, the prefill's (no autograd)."""
        return RankView(self, local, sinks, anchor)

    def decode_view(self, local: dict, t_groups: list, t_index: int) -> "DecodeView":
        """The decode's view: ``t_groups`` the groups of the axes that split
        the cache's T, ``t_index`` the rank's slice among them."""
        return DecodeView(self, local, t_groups, t_index)


class RankView:
    """The view ``models.transformer`` reads (see ``WholeModel``) for one
    rank of one micro-batch: ``local`` its parameter shards, ``sinks`` their
    float32 gradients, ``anchor`` a scalar that requires grad; ``sinks``
    None for the prefill (no autograd)."""

    def __init__(self, split: LMSplit, local: dict, sinks: dict | None,
                 anchor: torch.Tensor | None):
        self.split, self.local, self.sinks, self.anchor = split, local, sinks, anchor
        self.seq_parts = split.m
        self.heads = split.heads
        self.experts = split.experts
        self.ffn_split, self.shared_split = split.ffn_split, split.shared_split
        self._embed = None
        self.model_group = split.groups["model"]
        #: the last position of the sequence lies on the last model rank
        self.holds_last = split.r == split.m - 1

    def _fetch(self, path: str, i: int | None = None) -> torch.Tensor:
        gathers, narrow = self.split.plans[path]
        shard = self.local[path] if i is None else self.local[path][i]
        if self.sinks is None:
            w = tp.fetch_nograd(shard, gathers)
        else:
            sink = self.sinks[path] if i is None else self.sinks[path][i]
            w = tp.fetch(self.anchor, shard, sink, gathers)
        if self.split.on_fetch is not None:
            self.split.on_fetch(w)
        return w if narrow is None else w.narrow(*narrow)

    def embed(self) -> torch.Tensor:
        if self._embed is None:  # one gather a micro-batch, shared with a tied head
            self._embed = self._fetch("embed")
        return self._embed

    def head(self) -> torch.Tensor:
        return self.embed().T if self.split.cfg.tie_embeddings else self._fetch("lm_head")

    def final_norm(self) -> torch.Tensor:
        return self._fetch("final_norm")

    def layer(self, i: int) -> dict:
        return {name[len("layers/"):]: self._fetch(name, i) for name in self.local
                if name.startswith("layers/")}

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        return tp.gather(x, 1, self.model_group)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        return tp.scatter(x, 1, self.model_group)

    def gather_seq_nograd(self, x: torch.Tensor) -> torch.Tensor:
        return tp.gather_nograd(x, 1, self.model_group)

    def cache_rows(self, k: torch.Tensor, v: torch.Tensor):
        """A layer's k and v (B, T, kv heads of the rank, hd) over the gathered
        T, in the cache's dtype -> the rank's rows of the decode's cache (B, T
        / m, K, hd) each: one all-to-all over ``"model"``, in which each rank
        sends its owned kv heads' T slice j to model rank j."""
        sp = self.split
        if sp.m == 1:
            return k, v
        b, t, _, hd = k.shape
        m, tr = sp.m, t // sp.m
        ka = sp.kv_ranges[sp.r][0]
        oa, ob = sp.kv_owned[sp.r]
        mine = torch.stack([k[:, :, oa - ka:ob - ka], v[:, :, oa - ka:ob - ka]])
        send = mine.reshape(2, b, m, tr, ob - oa, hd).permute(2, 0, 1, 3, 4, 5).reshape(-1)
        unit = 2 * b * tr * hd
        counts = [hb - ha for ha, hb in sp.kv_owned]
        got = tp.all_to_all(send, [unit * n for n in counts], [unit * (ob - oa)] * m,
                            self.model_group)
        whole = torch.cat([piece.reshape(2, b, tr, n, hd) for piece, n in
                           zip(got.split([unit * n for n in counts]), counts)], dim=3)
        return whole[0], whole[1]


class DecodeView(RankView):
    """One rank's decode step (see the module docstring): its rows' tokens
    whole on every model rank, its slice ``t_index`` of the cache's T among
    the ranks of ``t_groups``."""

    def __init__(self, split: LMSplit, local: dict, t_groups: list, t_index: int):
        super().__init__(split, local, None, None)
        self.seq_parts = 1
        self.t_groups, self.t_index = t_groups, t_index

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        return x

    gather_seq_nograd = gather_seq

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The model ranks' partial sums of a row-parallel product, summed."""
        return tp.all_reduce(x, self.model_group)

    def _whole_heads(self, x: torch.Tensor, which: str) -> torch.Tensor:
        """``x`` (B, 1, heads of the rank, hd) gathered over ``"model"`` into
        every head (B, 1, n, hd) by the plan's ``whole_heads[which]``."""
        sp = self.split
        if sp.m == 1:
            return x
        width, index = sp.whole_heads[which]
        if x.shape[2] < width:
            x = torch.nn.functional.pad(x, (0, 0, 0, width - x.shape[2]))
        every = tp.gather_nograd(x, 2, self.model_group)
        key = (which, x.device)
        if key not in sp._index_on:  # once a plan and device: no copy to the card a step
            sp._index_on[key] = torch.tensor(index, device=x.device)
        return every[:, :, sp._index_on[key]]

    def decode_heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """q, k and v of the rank's heads -> of every head."""
        return (self._whole_heads(q, "q"), self._whole_heads(k, "kv"),
                self._whole_heads(v, "kv"))

    def own_heads(self, o: torch.Tensor) -> torch.Tensor:
        a, b = self.split.q_ranges[self.split.r]
        return o[:, :, a:b]

    def decode_write(self, cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                     new: torch.Tensor) -> None:
        """Row b's ``new`` (B, K, hd) into the rank's slice of a layer's cache
        (B, S / n, K, hd) at ``pos[b]``, on the rank whose slice holds it
        alone (no host sync: the other ranks write back what they hold)."""
        s = cache.shape[1]
        local = pos - self.t_index * s
        own = (local >= 0) & (local < s)
        at = local.clamp(0, s - 1)
        cache[rows, at] = torch.where(own[:, None, None], new, cache[rows, at])

    def decode_attend(self, q, k_cache, v_cache, pos32, pos, att: str) -> torch.Tensor:
        """Every head's attention over the whole cache: the rank's partial
        over its slice, joined over the T ranks, in q's dtype."""
        start = self.t_index * k_cache.shape[1]
        fn = (fd_ops.flash_decode_partial if att == "kernel"
              else fd_ops.flash_decode_partial_torch)
        o, lse = fn(q, k_cache, v_cache, pos32, start)
        return decode_split.combine_partials(o, lse, self.t_groups, q.dtype)[0]

