"""RecSys model zoo: FM, xDeepFM (CIN), SASRec, two-tower retrieval — the
serving path.

As in the reference (``repro.models.recsys``), the field-wise models keep
ONE concatenated (sum(vocab), dim) table with per-field row offsets.  Every
table lookup goes through ``kernels.embedding_bag``: a field lookup is a bag
of 1, and FM's and xDeepFM's linear term — the sum over the ``n_fields``
rows of ``linear[:, None]`` — and FM's sum of the field vectors are bags of
``n_fields``.  Each CIN layer of xDeepFM is one ``kernels.cin_layer``.
Attention and the MLPs stay plain tensor code, as the reference computes
them outside any kernel.  On CUDA tensors the kernels launch; on CPU
tensors their plain versions run.

Parameters are ``nn.Module``s holding the reference's arrays under its
names (lists such as ``cin``, ``mlp_w`` and ``blocks`` become
``ParameterList`` / ``ModuleList``), so :func:`recsys_params_from_reference`
carries the reference's weights across by copy.  Dtypes promote as in JAX
where the two frameworks differ: a product of float32 and bfloat16 operands
is float32 (:func:`_mm`), and SASRec's ``scores / np.sqrt(hd)`` is float32
(the numpy scalar is strongly typed in JAX).

Training (``sasrec_train_logits``, ``tt_train_loss`` and the logits of
FM / xDeepFM under autograd, driven by ``steps.make_recsys_train_step``):
with autograd on and a table that wants a gradient, each lookup goes
through ``kernels.embedding_bag.ops.EmbeddingBag`` and each CIN layer
through ``kernels.cin_interaction.ops.CinLayer`` — the kernel as the
forward (whatever this module's ``embedding_bag`` / ``cin_layer`` name at
the call) and a plain PyTorch backward; the table gradients are ordered
sums (``models.segment``), the same bits on the CPU and the card.  The
serving steps run these functions under ``torch.no_grad()``.

Field ids are checked against their field's vocabulary: the reference's
``jnp.take`` on the concatenated table would read a row of the next field
without a word.  Out of range raises ``IndexError`` at once for CPU ids and
trips a device-side assertion for CUDA ids (no host wait).  The two-tower
model keeps the reference's ``% n`` hashing, so any id is in range.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import RecsysConfig
from ..core.device import resolve_device
from ..kernels.cin_interaction.ops import CinLayer, cin_layer
from ..kernels.embedding_bag.ops import EmbeddingBag, embedding_bag
from .layers import rms_norm

N_USER_FIELDS = 16


# ----------------------------------------------------------------------
# shared embedding machinery
# ----------------------------------------------------------------------
def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.field_vocab_sizes)]).astype(np.int32)


def _rows(cfg: RecsysConfig, fields: torch.Tensor) -> torch.Tensor:
    """fields (B, n_fields) local ids -> (B, n_fields) int32 rows of the
    concatenated table, each id checked against its field's vocabulary."""
    offs = torch.from_numpy(field_offsets(cfg)).to(fields.device)
    sizes = offs[1:] - offs[:-1]
    inside = (fields >= 0) & (fields < sizes)
    if fields.device.type == "cuda":
        torch._assert_async(inside.all(), "recsys: a field id outside its field's vocabulary")
    elif not bool(inside.all()):
        bad = (~inside).nonzero()[0].tolist()
        raise IndexError(f"field id {int(fields[bad[0], bad[1]])} of field {bad[1]} outside "
                         f"its vocabulary of {int(sizes[bad[1]])}")
    return (fields + offs[:-1]).to(torch.int32)


def _bag(ids: torch.Tensor, table: torch.Tensor, bag: int) -> torch.Tensor:
    """``embedding_bag(ids, table, bag)``, through its autograd Function when
    the table wants a gradient."""
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBag.apply(ids, table, bag, embedding_bag)
    return embedding_bag(ids, table, bag)


def _cin(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``cin_layer(x0, xk, w)``, through its autograd Function when an
    input wants a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, xk, w)):
        return CinLayer.apply(x0, xk, w, cin_layer)
    return cin_layer(x0, xk, w)


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids of any shape) through ``embedding_bag`` with bags
    of 1, in the table's dtype (a float32 sum of one row is the row)."""
    out = _bag(ids.reshape(-1), table, 1)
    return out.to(table.dtype).reshape(*ids.shape, table.shape[1])


def embed_fields(table: torch.Tensor, fields: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """fields (B, n_fields) local ids -> (B, n_fields, dim)."""
    rows = fields + torch.from_numpy(np.asarray(offsets[:-1])).to(fields.device)
    return _lookup(table, rows)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (JAX's rule; PyTorch's
    matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mlp(x: torch.Tensor, ws, bs, act=F.relu) -> torch.Tensor:
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = _mm(x, w) + b
        if i + 1 < len(ws):
            x = act(x)
    return x


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def _plist(shapes, device) -> nn.ParameterList:
    return nn.ParameterList([_param(*s, device=device) for s in shapes])


def _mlp_shapes(dims):
    return [(a, b) for a, b in zip(dims[:-1], dims[1:])], [(b,) for b in dims[1:]]


class FM(nn.Module):
    """``table`` (sum(vocab), K), ``linear`` (sum(vocab),), ``bias`` ()."""

    FIELDS = ("table", "linear", "bias")

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__()
        total = sum(cfg.field_vocab_sizes)
        self.table = _param(total, cfg.embed_dim, device=device)
        self.linear = _param(total, device=device)
        self.bias = _param(device=device)


class XDeepFM(nn.Module):
    """FM's three plus ``cin`` ((m * H_prev, H) per CIN layer), ``mlp_w`` /
    ``mlp_b`` (the deep MLP from m * K to 1) and ``cin_out`` (sum(H), 1)."""

    FIELDS = ("table", "linear", "bias", "cin", "mlp_w", "mlp_b", "cin_out")

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__()
        total, m = sum(cfg.field_vocab_sizes), cfg.n_fields
        self.table = _param(total, cfg.embed_dim, device=device)
        self.linear = _param(total, device=device)
        self.bias = _param(device=device)
        prev, shapes = m, []
        for h in cfg.cin_layers:
            shapes.append((m * prev, h))
            prev = h
        self.cin = _plist(shapes, device)
        ws, bs = _mlp_shapes([m * cfg.embed_dim, *cfg.mlp_dims, 1])
        self.mlp_w, self.mlp_b = _plist(ws, device), _plist(bs, device)
        self.cin_out = _param(sum(cfg.cin_layers), 1, device=device)


class SASRec(nn.Module):
    """``item_emb`` (n_items, d), ``pos_emb`` (seq_len, d), ``blocks`` (one
    ParameterDict per block: ln1, wq, wk, wv, wo, ln2, w1, b1, w2, b2) and
    ``final_norm`` (d,)."""

    FIELDS = ("item_emb", "pos_emb", "blocks", "final_norm")
    BLOCK = {"ln1": lambda d: (d,), "wq": lambda d: (d, d), "wk": lambda d: (d, d),
             "wv": lambda d: (d, d), "wo": lambda d: (d, d), "ln2": lambda d: (d,),
             "w1": lambda d: (d, 4 * d), "b1": lambda d: (4 * d,),
             "w2": lambda d: (4 * d, d), "b2": lambda d: (d,)}

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__()
        d = cfg.embed_dim
        self.item_emb = _param(cfg.n_items, d, device=device)
        self.pos_emb = _param(cfg.seq_len, d, device=device)
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: _param(*s(d), device=device) for k, s in self.BLOCK.items()})
            for _ in range(cfg.n_blocks))
        self.final_norm = _param(d, device=device)


class TwoTower(nn.Module):
    """``user_table`` (n_users, d), ``item_table`` (n_items, d) and the two
    towers' MLPs ``user_mlp_w`` / ``user_mlp_b`` (from 16 * d) and
    ``item_mlp_w`` / ``item_mlp_b`` (from d)."""

    FIELDS = ("user_table", "item_table", "user_mlp_w", "user_mlp_b", "item_mlp_w",
              "item_mlp_b")

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__()
        d = cfg.embed_dim
        self.user_table = _param(cfg.n_users, d, device=device)
        self.item_table = _param(cfg.n_items, d, device=device)
        ws, bs = _mlp_shapes([d * N_USER_FIELDS, *cfg.tower_mlp])
        self.user_mlp_w, self.user_mlp_b = _plist(ws, device), _plist(bs, device)
        ws, bs = _mlp_shapes([d, *cfg.tower_mlp])
        self.item_mlp_w, self.item_mlp_b = _plist(ws, device), _plist(bs, device)


MODELS = {"fm-2way": FM, "cin": XDeepFM, "self-attn-seq": SASRec, "dot": TwoTower}


def _model_class(cfg: RecsysConfig):
    if cfg.interaction not in MODELS:
        raise ValueError(cfg.interaction)
    return MODELS[cfg.interaction]


def cast_params(params: nn.Module, dtype: torch.dtype):
    """The float32 parameters of ``params`` in ``dtype``, as a new object
    with the same attributes (lists and per-block dicts alike); the module
    itself is left as it is."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(dtype) if v.dtype == torch.float32 else v.detach()
        if isinstance(v, nn.ParameterDict):
            return {k: conv(x) for k, x in v.items()}
        return [conv(x) for x in v]

    return types.SimpleNamespace(**{k: conv(getattr(params, k)) for k in type(params).FIELDS})


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
@torch.no_grad()
def _init(cfg: RecsysConfig, generator: torch.Generator, device, small: dict) -> nn.Module:
    """Random weights drawn with ``generator`` on ``device``, following the
    reference's init: the tensors named in ``small`` N(0, 1) times their
    factor, every other matrix N(0, 1) / sqrt(fan-in), norms ones, biases
    zeros.  The numbers differ from ``jax.random``'s for the same seed."""
    dev = resolve_device(device)
    model = _model_class(cfg)(cfg, dev)
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        # drawn in place: a two-tower table is 10 GB
        if leaf in small:
            p.normal_(0.0, small[leaf], generator=generator)
        elif p.dim() == 2:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=generator)
        elif leaf in ("ln1", "ln2", "final_norm"):
            p.fill_(1)
        else:
            p.zero_()
    return model


def init_fm(cfg: RecsysConfig, generator: torch.Generator, device="cuda") -> FM:
    return _init(cfg, generator, device, {"table": 0.01, "linear": 0.01})


def init_xdeepfm(cfg: RecsysConfig, generator: torch.Generator, device="cuda") -> XDeepFM:
    return _init(cfg, generator, device, {"table": 0.01, "linear": 0.01})


def init_sasrec(cfg: RecsysConfig, generator: torch.Generator, device="cuda") -> SASRec:
    return _init(cfg, generator, device, {"item_emb": 0.01, "pos_emb": 0.01})


def init_two_tower(cfg: RecsysConfig, generator: torch.Generator, device="cuda") -> TwoTower:
    return _init(cfg, generator, device, {"user_table": 0.01, "item_table": 0.01})


@torch.no_grad()
def recsys_params_from_reference(cfg: RecsysConfig, params: dict, device="cuda") -> nn.Module:
    """The reference's ``init_fm`` / ``init_xdeepfm`` / ``init_sasrec`` /
    ``init_two_tower`` output, as a nested dict of NumPy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's model."""
    dev = resolve_device(device)
    model = _model_class(cfg)(cfg, dev)
    if set(params) != set(model.FIELDS):
        raise KeyError(f"reference params hold {sorted(params)}, expected {sorted(model.FIELDS)}")
    pairs = []
    for name in model.FIELDS:
        dst, src = getattr(model, name), params[name]
        if isinstance(dst, nn.ModuleList):
            if len(src) != len(dst) or any(set(s) != set(d) for s, d in zip(src, dst)):
                raise KeyError(f"{name}: reference blocks do not match the model's")
            pairs += [(d[k], s[k]) for s, d in zip(src, dst) for k in d]
        elif isinstance(dst, nn.ParameterList):
            if len(src) != len(dst):
                raise ValueError(f"{name}: {len(src)} reference arrays for {len(dst)}")
            pairs += list(zip(dst, src))
        else:
            pairs.append((dst, src))
    for dst, src in pairs:
        a = np.array(src, dtype=np.float32)
        if a.shape != tuple(dst.shape):
            raise ValueError(f"reference array of shape {a.shape} for a parameter of "
                             f"shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))
    return model


# ----------------------------------------------------------------------
# FM (Rendle 2010)
# ----------------------------------------------------------------------
def fm_logits(cfg: RecsysConfig, params, fields: torch.Tensor) -> torch.Tensor:
    rows = _rows(cfg, fields)
    m = cfg.n_fields
    v = _lookup(params.table, rows)  # (B, F, K)
    lin = _bag(rows, params.linear[:, None], m)[:, 0].to(params.linear.dtype)
    # O(nk) sum-square trick: 0.5 * ((sum v)^2 - sum v^2)
    s = _bag(rows, params.table, m).to(params.table.dtype)
    s2 = (v * v).sum(dim=1)
    pair = 0.5 * (s * s - s2).sum(dim=-1)
    return params.bias + lin + pair


# ----------------------------------------------------------------------
# xDeepFM (CIN + deep MLP)
# ----------------------------------------------------------------------
def xdeepfm_logits(cfg: RecsysConfig, params, fields: torch.Tensor) -> torch.Tensor:
    rows = _rows(cfg, fields)
    x0 = _lookup(params.table, rows)  # (B, m, K)
    lin = _bag(rows, params.linear[:, None], cfg.n_fields)[:, 0].to(params.linear.dtype)
    # CIN: x^{l+1}_{h,:} = sum_{i,j} W^l_{h,ij} (x0_i * xl_j), one kernel a layer
    xl = x0
    pooled = []
    for w in params.cin:
        xl = _cin(x0, xl, w).to(x0.dtype)  # (B, H, K)
        pooled.append(xl.sum(dim=-1))  # (B, H)
    cin_term = _mm(torch.cat(pooled, dim=-1), params.cin_out)[:, 0]
    deep = _mlp(x0.reshape(x0.shape[0], -1), params.mlp_w, params.mlp_b)[:, 0]
    return params.bias + lin + cin_term + deep


# ----------------------------------------------------------------------
# SASRec (self-attentive sequential recommendation)
# ----------------------------------------------------------------------
def sasrec_encode(cfg: RecsysConfig, params, hist: torch.Tensor) -> torch.Tensor:
    """hist (B, T) item ids (0 = pad) -> (B, T, d) causal sequence states."""
    b, t = hist.shape
    d = cfg.embed_dim
    h = _lookup(params.item_emb, hist) + params.pos_emb[None, :t]
    mask = (hist > 0)[:, :, None]
    h = h * mask
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=hist.device))
    nh = max(1, cfg.n_heads)
    hd = d // nh
    for blk in params.blocks:
        hn = rms_norm(h, blk["ln1"])
        q, k, v = (_mm(hn, blk[w]).reshape(b, t, nh, hd) for w in ("wq", "wk", "wv"))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        scores = torch.where(causal[None, None], scores, -1e30)
        att = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v.to(att.dtype)).reshape(b, t, d)
        h = h + _mm(o, blk["wo"])
        hn = rms_norm(h, blk["ln2"])
        h = h + _mm(F.relu(_mm(hn, blk["w1"]) + blk["b1"]), blk["w2"]) + blk["b2"]
    return rms_norm(h, params.final_norm) * mask


def sasrec_train_logits(cfg: RecsysConfig, params, hist: torch.Tensor, labels: torch.Tensor,
                        negatives: torch.Tensor):
    """BPR-style: ``(pos, neg)`` (B, T) scores of the next-item positives and
    of sampled negatives."""
    h = sasrec_encode(cfg, params, hist)  # (B, T, d)
    pos_e = _lookup(params.item_emb, labels)
    neg_e = _lookup(params.item_emb, negatives)
    return torch.sum(h * pos_e, dim=-1), torch.sum(h * neg_e, dim=-1)


def sasrec_serve_scores(cfg: RecsysConfig, params, hist: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
    h = sasrec_encode(cfg, params, hist)[:, -1]  # (B, d)
    te = _lookup(params.item_emb, target)
    return torch.sum(h * te, dim=-1)


def sasrec_retrieval(cfg: RecsysConfig, params, hist: torch.Tensor,
                     candidates: torch.Tensor) -> torch.Tensor:
    """Score each user against the candidate items: one batched product."""
    h = sasrec_encode(cfg, params, hist)[:, -1]  # (B, d)
    ce = _lookup(params.item_emb, candidates)  # (N, d)
    return _mm(h, ce.T)  # (B, N)


# ----------------------------------------------------------------------
# two-tower retrieval
# ----------------------------------------------------------------------
def _normalize(u: torch.Tensor) -> torch.Tensor:
    return u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-6)


def tt_user_tower(cfg: RecsysConfig, params, user_feats: torch.Tensor) -> torch.Tensor:
    """user_feats (B, N_USER_FIELDS) hashed ids -> (B, out_dim) normalised."""
    e = _lookup(params.user_table, user_feats % params.user_table.shape[0])
    return _normalize(_mlp(e.reshape(e.shape[0], -1), params.user_mlp_w, params.user_mlp_b))


def tt_item_tower(cfg: RecsysConfig, params, item_ids: torch.Tensor) -> torch.Tensor:
    e = _lookup(params.item_table, item_ids % params.item_table.shape[0])
    return _normalize(_mlp(e, params.item_mlp_w, params.item_mlp_b))


def tt_train_loss(cfg: RecsysConfig, params, user_feats, item_ids, labels):
    """In-batch sampled softmax (every other item of the batch a negative):
    ``(loss, {"nll": loss})``."""
    u = tt_user_tower(cfg, params, user_feats)  # (B, d)
    v = tt_item_tower(cfg, params, item_ids)  # (B, d)
    logits = _mm(u, v.T) * 20.0  # temperature
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.diagonal(logp))
    return loss, {"nll": loss}


def tt_retrieval(cfg: RecsysConfig, params, user_feats, candidates) -> torch.Tensor:
    u = tt_user_tower(cfg, params, user_feats)  # (B, d)
    v = tt_item_tower(cfg, params, candidates)  # (N, d)
    return _mm(u, v.T)
