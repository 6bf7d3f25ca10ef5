"""Document-partitioned anchored index, on one device or across the ranks
of a mesh.

Each shard owns the postings of one *document range* (or, for positional
phrase serving, one *position range* cut at document boundaries), re-based
to local ids, with its own anchored Re-Pair arrays.  Per-shard arrays are
padded to a common size and stacked with a leading shard dimension — int32
and bool, padded exactly as the reference pads them — and results come back
as (shards, batch, cand) with global ids: the broadcast-query /
local-search / merge-results topology of a sharded search tier.

On one device every shard is served by **one batched step**.  The stacked
arrays are viewed flat (anchors ``(S * max_nc,)``, expand ``(S * max_nc, el)``,
reshapes of the same storage), and one small int32 array holds each shard's
C-offsets shifted by ``s * max_nc``, so list ``t`` of shard ``s`` is list
``s * (T + 1) + t`` of one ordinary :class:`AnchoredIndex` and its slice
never reaches another shard's entries or the padding between shards.  The
``(B, W)`` query block is replicated to ``(S * B, W)`` with offset term
ids, so a window is one candidate gather and one probe per probed term for
all shards together (``probe="kernel"``: one ``anchor_probe_sliced``
launch per probed term per window, whatever ``S``).

On a mesh (a ``DeviceMesh``, ``repro_torch.sharding.compat.make_mesh``) each
rank along ``shard_axis`` holds ``S / n`` of the stacked shards on its own
device — a slice of the leading dimension of every array, ``doc_base``
included, so ids stay the global shards' — and runs the same batched step
over its local shards; the ``(S / n, B, C)`` values and masks are then
all-gathered along ``shard_axis`` to ``(S, B, C)``, as the reference's
``shard_map`` returns them.  Ranks along the other axes hold the same
shards and give the same answers.  Every rank must sweep the same windows
(each window is one ``all_gather``): the window count comes from the global
C-offsets of all shards, never from the local ones.

Both query kinds of the batched engine run under this layout: conjunctive
AND (mode="and") and offset-shifted phrase probes (mode="phrase"); the
``row_start`` argument is the same candidate-window cursor as in
``engine.candidates_for``, so long per-shard lists are swept exactly.

:class:`PartitionedServer` wraps the sharded layout in the batched-server
protocol (``conjunctive`` / ``phrase`` / ``encode`` / ``trace_count``), so
a ``Session`` can route device traffic onto the shards exactly like onto a
single :class:`~repro_torch.serving.engine.BatchedServer` — it declares
``kinds = {"and", "phrase"}`` and the plan compiler keeps top-k and doc
listing on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..core.anchors import AnchoredIndex, build_anchored
from ..core.device import resolve_device
from ..sharding.compat import mesh_device, require_device_mesh
from .engine import (
    MAX_CAND_ROWS,
    _kernel_member,
    _probe_terms,
    candidates_for,
    encode_queries,
    resolve_probe,
)
from .plan import PHRASE

_INT32_MAX = 2**31 - 1


def _axis_size(mesh, shard_axis: str, what: str) -> int:
    require_device_mesh(mesh, what)
    names = tuple(mesh.mesh_dim_names)
    if shard_axis not in names:
        raise ValueError(f"{what}: shard_axis={shard_axis!r} is not an axis of the mesh {names}")
    return mesh.size(names.index(shard_axis))


def shard_offsets(c_offsets: np.ndarray, max_nc: int) -> np.ndarray:
    """Each shard's C-offsets ``(S, T + 1)`` shifted by ``s * max_nc`` and
    flattened to ``(S * (T + 1),)`` int32: the list table of the flat view
    of the stacked arrays.  Refuses a layout whose flat entry count does not
    fit int32 (nothing may wrap)."""
    c_offsets = np.asarray(c_offsets, dtype=np.int64)
    n_shards = c_offsets.shape[0]
    if n_shards * int(max_nc) > _INT32_MAX:
        raise ValueError(
            f"{n_shards} shards x {max_nc} C entries = {n_shards * int(max_nc)} "
            f"flat entries do not fit int32; use fewer or smaller shards")
    shifted = c_offsets + (np.arange(n_shards, dtype=np.int64) * int(max_nc))[:, None]
    return shifted.reshape(-1).astype(np.int32)


@dataclass
class PartitionedAnchoredIndex:
    arrays: dict[str, torch.Tensor]  # each with leading (n_shards,) dim
    doc_bounds: np.ndarray  # (n_shards + 1,) global doc-range boundaries
    n_shards: int  # the shards held here (a rank's own on a mesh)
    expand_len: int
    #: the first shard held here, and the C-offsets (S, T + 1) of all the
    #: layout's shards (``None``: the shards held here are all of them)
    first_shard: int = 0
    global_c_offsets: np.ndarray | None = None
    #: ``shard_offsets`` of ``arrays["c_offsets"]``, on the arrays' device
    flat_c_offsets: torch.Tensor = field(init=False)

    def __post_init__(self):
        c_off = self.arrays["c_offsets"]
        self.flat_c_offsets = torch.from_numpy(shard_offsets(
            c_off.cpu().numpy(), self.arrays["anchors"].shape[1])).to(c_off.device)

    @classmethod
    def build(cls, lists: list[np.ndarray], n_docs: int, n_shards: int,
              bounds: np.ndarray | None = None, device="cuda",
              **kw) -> "PartitionedAnchoredIndex":
        """``bounds`` overrides the equal-width split — pass document-start
        positions for a positional index so phrases never span shards.  The
        shards are built on the host (Python Re-Pair) and the stacked arrays
        copied onto ``device`` once (``"cuda"`` unless the caller asks for
        ``"cpu"``)."""
        dev = resolve_device(device)
        if bounds is None:
            bounds = np.linspace(0, n_docs, n_shards + 1).astype(np.int64)
        else:
            bounds = np.asarray(bounds, dtype=np.int64)
            if len(bounds) != n_shards + 1:
                raise ValueError(f"{len(bounds)} bounds for {n_shards} shards; "
                                 f"pass n_shards + 1")
        shards: list[AnchoredIndex] = []
        for s in range(n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            local = []
            for l in lists:
                seg = l[(l >= lo) & (l < hi)] - lo  # re-based to local ids
                local.append(seg if len(seg) else np.asarray([], dtype=np.int64))
            shards.append(build_anchored(local, device="cpu", **kw))
        # pad to common sizes and stack
        max_nc = max(int(a.anchors.shape[0]) for a in shards)
        el = max(a.expand_len for a in shards)
        n_terms = len(lists)

        def pad1(x: torch.Tensor, n, fill=0):
            return np.pad(x.numpy(), (0, n - len(x)), constant_values=fill)

        def pad2(x: torch.Tensor, n, w, fill=0):
            return np.pad(x.numpy(), ((0, n - x.shape[0]), (0, w - x.shape[1])),
                          constant_values=fill)

        stacked = {
            "anchors": np.stack([
                pad1(a.anchors, max_nc, fill=_INT32_MAX) for a in shards]).astype(np.int32),
            "c_offsets": np.stack([
                pad1(a.c_offsets, n_terms + 1, fill=int(a.c_offsets[-1])) for a in shards]
            ).astype(np.int32),
            "expand": np.stack([pad2(a.expand, max_nc, el) for a in shards]).astype(np.int32),
            "expand_valid": np.stack([
                pad2(a.expand_valid, max_nc, el) for a in shards]).astype(bool),
            "lengths": np.stack([pad1(a.lengths, n_terms) for a in shards]).astype(np.int32),
            "doc_base": bounds[:-1].astype(np.int32),
        }
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in stacked.items()}
        return cls(arrays=arrays, doc_bounds=bounds, n_shards=n_shards, expand_len=el)

    @classmethod
    def from_index(cls, index, n_shards: int, device="cuda",
                   **kw) -> "PartitionedAnchoredIndex":
        """Shard a built index whatever backend it uses: posting lists are
        pulled through the ``SearchBackend`` protocol (``get_list``), so the
        sharded layout works for inverted stores and self-index adapters
        alike.  Positional indexes (``n_tokens`` universe) are cut at
        document boundaries so phrases never span shards."""
        store = index.store
        lists = [np.asarray(store.get_list(i)) for i in range(store.n_lists)]
        universe = int(index.universe_size)
        bounds = None
        if hasattr(index, "n_tokens"):  # positional: align shard cuts to docs
            starts = np.asarray(index.doc_starts, dtype=np.int64)
            picks = np.linspace(0, len(starts), n_shards + 1).astype(np.int64)[1:-1]
            bounds = np.concatenate([[0], starts[picks], [universe]])
        return cls.build(lists, n_docs=universe, n_shards=n_shards, bounds=bounds,
                         device=device, **kw)

    @property
    def device(self) -> torch.device:
        return self.arrays["anchors"].device

    def all_c_offsets(self) -> np.ndarray:
        """(S, T + 1) C-offsets of every shard of the layout (the window
        count of a sweep comes from these, on every rank alike)."""
        if self.global_c_offsets is not None:
            return self.global_c_offsets
        return self.arrays["c_offsets"].cpu().numpy()

    def local_shards(self, mesh, shard_axis: str = "data") -> "PartitionedAnchoredIndex":
        """This rank's ``S / n`` shards along ``shard_axis`` of ``mesh`` (``n``
        its size), copied onto the rank's device; ``S`` not divisible by ``n``
        raises, as the reference's ``shard_map`` does."""
        if self.global_c_offsets is not None:
            raise ValueError("local_shards: this layout already holds one rank's shards")
        n = _axis_size(mesh, shard_axis, "local_shards")
        if self.n_shards % n:
            raise ValueError(f"{self.n_shards} shards do not divide over the {n} ranks of "
                             f"mesh axis {shard_axis!r}")
        per = self.n_shards // n
        lo = mesh.get_local_rank(shard_axis) * per
        dev = mesh_device(mesh)
        arrays = {k: v[lo:lo + per].to(dev).clone() for k, v in self.arrays.items()}
        return PartitionedAnchoredIndex(arrays=arrays, doc_bounds=self.doc_bounds,
                                        n_shards=per, expand_len=self.expand_len,
                                        first_shard=lo, global_c_offsets=self.all_c_offsets())

    def step_arrays(self) -> dict[str, torch.Tensor]:
        """The stacked arrays plus the flat list table the batched step reads."""
        return {**self.arrays, "flat_c_offsets": self.flat_c_offsets}

    def device_bytes(self) -> int:
        """Device bytes of the stacked arrays and the flat list table held
        here (on a mesh, a rank's; their sum over the shard axis is the
        one-device number)."""
        return sum(t.numel() * t.element_size() for t in self.step_arrays().values())


def _flat_index(arrays: dict) -> AnchoredIndex:
    """The stacked shard arrays as one :class:`AnchoredIndex` (views of the
    same storage, plus the shifted list table)."""
    s, max_nc = arrays["anchors"].shape
    el = arrays["expand"].shape[-1]
    return AnchoredIndex(
        anchors=arrays["anchors"].reshape(-1), c_offsets=arrays["flat_c_offsets"],
        expand=arrays["expand"].reshape(s * max_nc, el),
        expand_valid=arrays["expand_valid"].reshape(s * max_nc, el),
        lengths=arrays["lengths"].reshape(-1), expand_len=el)


def make_partitioned_serve_step(max_terms: int, mesh=None, shard_axis: str = "data",
                                mode: str = "and", probe: str = "torch"):
    """Returns serve(arrays, query_terms, query_lens, row_start=0) ->
    (vals, mask), each (n_shards, B, C): every shard's window of the same
    step in one batched pass (see the module docstring); ``arrays`` is
    :meth:`PartitionedAnchoredIndex.step_arrays` of the shards held here.
    ``mode`` selects AND or offset-shifted phrase probes; ``probe="kernel"``
    probes each term with the ``anchor_probe_sliced`` kernel, ``"torch"``
    with plain tensor code.  With a ``mesh`` the arrays are this rank's
    shards along ``shard_axis`` and the results are all-gathered along it to
    every shard's (every rank of the axis must call the step together)."""
    n_ranks = None if mesh is None else _axis_size(mesh, shard_axis,
                                                      "make_partitioned_serve_step")
    member = _kernel_member() if probe == "kernel" else None
    phrase = mode == PHRASE

    def serve(arrays: dict, query_terms: torch.Tensor, query_lens: torch.Tensor,
              row_start: int = 0):
        idx = _flat_index(arrays)
        s = arrays["anchors"].shape[0]
        b, w = query_terms.shape
        n_lists = arrays["c_offsets"].shape[1]  # T + 1 slots a shard
        shift = torch.arange(s, dtype=torch.int32, device=query_terms.device) * n_lists
        qt = (query_terms[None] + shift[:, None, None]).reshape(s * b, w)
        ql = query_lens.repeat(s)
        cand_vals, cand_valid = candidates_for(idx, qt[:, 0], row_start)
        match = _probe_terms(idx, qt, ql, cand_vals, cand_valid, max_terms,
                             phrase, member=member)
        # back to global ids (int32, as the reference's)
        base = arrays["doc_base"].repeat_interleave(b)[:, None]
        vals = cand_vals - 1 + base
        return vals.reshape(s, b, -1), match.reshape(s, b, -1)

    if mesh is None:
        return serve
    group = mesh.get_group(shard_axis)

    def serve_gathered(arrays: dict, query_terms: torch.Tensor, query_lens: torch.Tensor,
                       row_start: int = 0):
        vals, match = serve(arrays, query_terms, query_lens, row_start)
        # one collective a window: values and masks packed as int32
        packed = torch.stack([vals, match.to(torch.int32)], dim=1).contiguous()
        parts = [torch.empty_like(packed) for _ in range(n_ranks)]
        dist.all_gather(parts, packed, group=group)
        full = torch.cat(parts)  # (S, 2, B, C), shards in the axis' order
        return full[:, 0], full[:, 1].bool()

    return serve_gathered


def serve_partitioned_windowed(pidx: PartitionedAnchoredIndex, serve, qt, ql) -> list[np.ndarray]:
    """Sweep candidate windows across all shards and merge: exact results
    for per-shard lists of any length (concatenating per-shard hits)."""
    c_off = pidx.all_c_offsets()  # (S, n_terms + 1) of every shard
    first = np.asarray(qt)[:, 0]
    rows = (c_off[:, first + 1] - c_off[:, first]).max()
    dev = pidx.device
    qt_d = torch.as_tensor(np.asarray(qt, dtype=np.int32), device=dev)
    ql_d = torch.as_tensor(np.asarray(ql, dtype=np.int32), device=dev)
    arrays = pidx.step_arrays()
    hits: list[list[np.ndarray]] = [[] for _ in range(len(first))]
    with torch.no_grad():
        for w in range(max(1, -(-int(rows) // MAX_CAND_ROWS))):
            vals, mask = serve(arrays, qt_d, ql_d, w * MAX_CAND_ROWS)
            vals, mask = vals.cpu().numpy(), mask.cpu().numpy()
            for qi in range(vals.shape[1]):
                hits[qi].append(vals[:, qi][mask[:, qi]])
    return [np.unique(np.concatenate(h)) for h in hits]


def merge_results(vals: np.ndarray, mask: np.ndarray) -> list[np.ndarray]:
    """(S, B, C) -> per-query sorted global doc ids."""
    vals, mask = np.asarray(vals), np.asarray(mask)
    s, b, c = vals.shape
    out = []
    for qi in range(b):
        hits = vals[:, qi][mask[:, qi]]
        out.append(np.unique(hits))
    return out


# ----------------------------------------------------------------------
# Session-compatible driver over the sharded layout
# ----------------------------------------------------------------------
@dataclass
class PartitionedServer:
    """Batched-server protocol over a :class:`PartitionedAnchoredIndex`.

    Every window of every shard runs as one batched step on the index's
    device (see the module docstring) — exact and step-cached, so a
    ``Session`` serves a sharded layout through the same ``execute``.  Only
    conjunctive and phrase steps exist shard-local (``kinds``); the plan
    compiler routes top-k / doc listing to the host.  ``probe`` is
    ``"kernel"`` (the CUDA kernel; default on a GPU) or ``"torch"`` (plain
    tensor code; default on the CPU).  With a ``mesh`` (a ``DeviceMesh``)
    ``pidx`` is the whole layout, of which each rank keeps its shards along
    ``shard_axis`` on its device (:meth:`PartitionedAnchoredIndex.
    local_shards`); every rank must then run the same queries together.
    """

    pidx: PartitionedAnchoredIndex
    host_index: object  # the built index the shards were cut from (lookup())
    mesh: object | None = None
    shard_axis: str = "data"
    kinds: frozenset = frozenset({"and", "phrase"})
    _steps: dict = field(default_factory=dict)
    trace_events: int = 0
    _lengths_np: np.ndarray | None = None  # global lengths: sum over shards
    _c_offsets_np: np.ndarray | None = None  # (S, T+1) per-shard C-offsets
    probe: str | None = None
    windows_swept: int = 0  # batched window steps run (all shards in each)

    def __post_init__(self):
        if self._lengths_np is None:
            self._lengths_np = self.pidx.arrays["lengths"].cpu().numpy().sum(axis=0)
        if self._c_offsets_np is None:
            self._c_offsets_np = self.pidx.all_c_offsets()
        if self.mesh is not None:
            self.pidx = self.pidx.local_shards(self.mesh, self.shard_axis)
        self.probe = resolve_probe(self.probe, self.pidx.device)
        self._arrays = self.pidx.step_arrays()

    @classmethod
    def from_index(cls, index, n_shards: int, mesh=None, shard_axis: str = "data",
                   device="cuda", probe: str | None = None, **kw) -> "PartitionedServer":
        """Shard an already-built index (any registered backend) into the
        partitioned layout on ``device`` — the in-memory counterpart of
        :meth:`open`, used by the replicated serving tier to stamp out shard
        sets.  With a ``mesh`` the layout is built on the host and each rank
        copies its own shards onto its device (``device`` must name the
        mesh's device type)."""
        dev = resolve_device(device)
        if mesh is not None:
            _axis_size(mesh, shard_axis, "PartitionedServer.from_index")
            if dev.type != mesh.device_type:
                raise ValueError(f"device={device!r} on a {mesh.device_type!r} mesh")
        probe = resolve_probe(probe, dev)
        pidx = PartitionedAnchoredIndex.from_index(
            index, n_shards=n_shards, device="cpu" if mesh is not None else dev, **kw)
        return cls(pidx=pidx, host_index=index, mesh=mesh, shard_axis=shard_axis,
                   probe=probe)

    @classmethod
    def open(cls, path, n_shards: int, mesh=None, shard_axis: str = "data",
             device="cuda", probe: str | None = None, **kw) -> "PartitionedServer":
        """Open a persisted index artifact (``repro_torch.core.artifact``)
        and shard it: each shard re-anchors its document range of the
        reopened backend's postings, so a persisted single-machine artifact
        serves a sharded layout without rebuilding the index."""
        from ..core.artifact import open_index

        return cls.from_index(open_index(path, device=device), n_shards=n_shards,
                              mesh=mesh, shard_axis=shard_axis, device=device,
                              probe=probe, **kw)

    @property
    def device(self) -> torch.device:
        return self.pidx.device

    @property
    def trace_count(self) -> int:
        return self.trace_events

    def c_entries(self, list_id: int) -> int:
        """Max C-entries of one list over the shards (window-sweep length)."""
        c = self._c_offsets_np
        return int((c[:, list_id + 1] - c[:, list_id]).max())

    def encode(self, queries: list[list[str]], sort_by_length: bool = False,
               width: int | None = None):
        """Pad to (B, width) global term ids (the shared
        :func:`~repro_torch.serving.engine.encode_queries` step; lengths for
        the rarest-first sort are the shard-summed global list lengths)."""
        return encode_queries(self.host_index, self._lengths_np, queries,
                              sort_by_length=sort_by_length, width=width)

    def _step(self, mode: str, width: int):
        key = (mode, width)
        if key not in self._steps:
            self.trace_events += 1  # a step-cache miss: a new traffic shape
            self._steps[key] = make_partitioned_serve_step(
                max_terms=width, mesh=self.mesh, shard_axis=self.shard_axis, mode=mode,
                probe=self.probe)
        return self._steps[key]

    def _sweep(self, mode: str, queries: list[list[str]],
               width: int | None = None) -> list[np.ndarray]:
        qt, ql, ok = self.encode(queries, sort_by_length=(mode != PHRASE),
                                 width=width)
        serve = self._step(mode, qt.shape[1])
        c = self._c_offsets_np
        first = qt[:, 0][ok] if ok.any() else qt[:1, 0]
        rows = int((c[:, first + 1] - c[:, first]).max())
        hits: list[list[np.ndarray]] = [[] for _ in queries]
        dev = self.device
        with torch.no_grad():
            qt_d = torch.from_numpy(qt).to(dev)
            ql_d = torch.from_numpy(ql).to(dev)
            for w in range(max(1, -(-rows // MAX_CAND_ROWS))):
                vals, mask = serve(self._arrays, qt_d, ql_d, w * MAX_CAND_ROWS)
                self.windows_swept += 1
                vals, mask = vals.cpu().numpy(), mask.cpu().numpy()
                for qi in np.flatnonzero(ok):
                    hits[qi].append(vals[:, qi][mask[:, qi]])
        empty = np.zeros(0, np.int64)
        return [np.unique(np.concatenate(h)).astype(np.int64) if (o and h) else empty
                for h, o in zip(hits, ok)]

    def conjunctive(self, queries: list[list[str]],
                    width: int | None = None) -> list[np.ndarray]:
        """Batched AND across all shards: sorted global doc ids, exact."""
        return self._sweep("and", queries, width=width)

    def phrase(self, queries: list[list[str]],
               width: int | None = None) -> list[np.ndarray]:
        """Batched phrase across all shards (cut shard bounds at document
        starts so phrases never span shards)."""
        return self._sweep(PHRASE, queries, width=width)
