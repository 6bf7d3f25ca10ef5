"""Trip-count-aware cost analysis of optimized (post-SPMD) HLO text: the
port's own copy of ``repro.launch.hlo_cost``, so that the dry-run's records
and the tests keep the reference's cost model and field names
(:class:`HLOCost`, ``as_dict``).  The port compiles no HLO; its dry-run
(:mod:`.dryrun`) counts a rank's step with PyTorch's dispatch modes and
reports the same fields.  The reference's notes follow.

Why: ``compiled.cost_analysis()`` reports the FLOPs/bytes of a ``while``
body **once**, ignoring the trip count — for scan-over-layers models (and
flash-attention KV scans) that understates compute by 1–2 orders of
magnitude, and the same bug hits naive collective-byte counting.  This
module parses the HLO text, builds the computation call graph, extracts
``known_trip_count`` from while backend configs, and multiplies through.

Cost model (per device, since the module is the SPMD-partitioned one):
 * FLOPs: 2 * prod(result) * prod(contracting dims) per ``dot``;
   matmul-like custom-calls are handled best-effort.  Elementwise FLOPs are
   ignored (sub-1% for the architectures here).
 * HBM bytes: operand + result bytes at *fusion boundaries* — structural
   ops (tuple plumbing, parameters, constants, bitcasts) are free, fusion
   internals are not double counted.  A first-order proxy of XLA's own
   bytes-accessed, with trip counts applied.
 * Collective bytes: result sizes of all-gather / all-reduce /
   reduce-scatter / all-to-all / collective-permute (+ their async -start
   forms), with trip counts applied.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([a-z][a-z0-9\-]*)\((.*)$")
_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s+->\s+.*\{")


def _shape_dims(shape_str: str) -> list[tuple[str, list[int]]]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        out.append((dtype, [int(d) for d in dims.split(",")] if dims else []))
    return out


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dtype]
    return total


_STRUCTURAL = {
    "parameter", "tuple", "get-tuple-element", "constant", "bitcast",
    "after-all", "partition-id", "replica-id", "iota", "get-dimension-size",
    "opt-barrier", "domain",
}


@dataclass
class _Instr:
    name: str
    shape: str
    op: str
    rest: str  # operands + attrs (everything after the opening paren)


@dataclass
class _Comp:
    name: str
    instrs: list[_Instr] = field(default_factory=list)
    shapes: dict[str, str] = field(default_factory=dict)


def _parse_computations(hlo: str) -> tuple[dict[str, _Comp], str]:
    comps: dict[str, _Comp] = {}
    entry = ""
    cur: _Comp | None = None
    for raw in hlo.splitlines():
        line = raw.rstrip()
        s = line.strip()
        if cur is None:
            m = _COMP_RE.match(s)
            if m:
                cur = _Comp(name=m.group(2))
                if m.group(1):
                    entry = cur.name
                comps[cur.name] = cur
            continue
        if s == "}" or s.startswith("} "):
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, shape, op, rest = m.groups()
        inst = _Instr(name=name, shape=shape, op=op, rest=rest)
        cur.instrs.append(inst)
        cur.shapes[name] = shape
    return comps, entry


def _operand_names(rest: str) -> list[str]:
    """Names referenced before the closing paren of the operand list."""
    depth = 1
    out = []
    token = ""
    for ch in rest:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                break
        if depth >= 1:
            token += ch
    return re.findall(r"%([\w.\-]+)", token)


def _attr(rest: str, key: str) -> str | None:
    m = re.search(key + r"=\{([0-9,]*)\}", rest)
    return m.group(1) if m else None


def _called(rest: str) -> list[tuple[str, str]]:
    """(role, computation) pairs referenced in attributes."""
    out = []
    for key in ("calls", "condition", "body", "to_apply"):
        m = re.search(key + r"=%?([\w.\-]+)", rest)
        if m:
            out.append((key, m.group(1)))
    m = re.search(r"branch_computations=\{([^}]*)\}", rest)
    if m:
        for name in re.findall(r"%?([\w.\-]+)", m.group(1)):
            out.append(("branch", name))
    return out


def _trip_count(rest: str) -> int:
    m = re.search(r'"known_trip_count":\{"n":"(\d+)"\}', rest)
    return int(m.group(1)) if m else 1


def _dot_flops(comp: _Comp, inst: _Instr) -> float:
    result_elems = 0
    for _, dims in _shape_dims(inst.shape):
        n = 1
        for d in dims:
            n *= d
        result_elems += n
    ops = _operand_names(inst.rest)
    if not ops:
        return 0.0
    lhs_shape = comp.shapes.get(ops[0])
    if lhs_shape is None:
        return 2.0 * result_elems  # unknown contraction; floor
    lhs_dims = _shape_dims(lhs_shape)
    if not lhs_dims:
        return 0.0
    dims = lhs_dims[0][1]
    contract = _attr(inst.rest, "lhs_contracting_dims")
    k = 1
    if contract:
        for idx in contract.split(","):
            if idx != "" and int(idx) < len(dims):
                k *= dims[int(idx)]
    return 2.0 * result_elems * k


def _custom_call_flops(comp: _Comp, inst: _Instr) -> float:
    if "matmul" not in inst.rest and "dot" not in inst.rest.lower():
        return 0.0
    # best effort: 2 * prod(result) * K with K = last dim of first operand
    result_elems = 0
    for _, dims in _shape_dims(inst.shape):
        n = 1
        for d in dims:
            n *= d
        result_elems += n
    ops = _operand_names(inst.rest)
    if ops:
        lhs = comp.shapes.get(ops[0])
        if lhs:
            d = _shape_dims(lhs)
            if d and d[0][1]:
                return 2.0 * result_elems * d[0][1][-1]
    return 2.0 * result_elems


@dataclass
class HLOCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)
    n_while: int = 0
    max_trip: int = 1

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "bytes_by_op": self.bytes_by_op,
            "count_by_op": self.count_by_op,
            "n_while": self.n_while,
            "max_trip": self.max_trip,
        }


def analyze_hlo(hlo: str) -> HLOCost:
    comps, entry = _parse_computations(hlo)
    cost = HLOCost()
    memo: dict[str, tuple[float, float, float, dict, dict]] = {}

    def comp_cost(name: str) -> tuple[float, float, float, dict, dict]:
        if name in memo:
            return memo[name]
        comp = comps.get(name)
        if comp is None:
            return (0.0, 0.0, 0.0, {}, {})
        memo[name] = (0.0, 0.0, 0.0, {}, {})  # cycle guard
        flops = 0.0
        hbm = 0.0
        coll = 0.0
        by_op: dict[str, float] = {}
        cnt_op: dict[str, float] = {}
        for inst in comp.instrs:
            op = inst.op
            base = op[:-6] if op.endswith("-start") else op
            if op.endswith("-done") or op.endswith("-update"):
                continue
            if op == "dot":
                flops += _dot_flops(comp, inst)
            elif op == "custom-call":
                flops += _custom_call_flops(comp, inst)
            if base in COLLECTIVE_OPS:
                b = _shape_bytes(inst.shape)
                coll += b
                by_op[base] = by_op.get(base, 0.0) + b
                cnt_op[base] = cnt_op.get(base, 0.0) + 1
            # HBM bytes at fusion boundaries
            if op not in _STRUCTURAL and op != "while":
                b = _shape_bytes(inst.shape)
                for on in _operand_names(inst.rest):
                    sh = comp.shapes.get(on)
                    if sh:
                        b += _shape_bytes(sh)
                hbm += b
            # recurse into called computations
            mult = 1
            if op == "while":
                mult = _trip_count(inst.rest)
                cost.n_while += 1
                cost.max_trip = max(cost.max_trip, mult)
            for role, cname in _called(inst.rest):
                if op == "fusion" and role == "calls":
                    # fused internals: dots only (bytes live at the boundary)
                    f2, _, c2, b2, n2 = comp_cost(cname)
                    flops += f2
                    coll += c2
                    for k, v in b2.items():
                        by_op[k] = by_op.get(k, 0.0) + v
                    for k, v in n2.items():
                        cnt_op[k] = cnt_op.get(k, 0.0) + v
                elif role == "to_apply":
                    continue  # reduction lambdas: negligible
                else:
                    f2, h2, c2, b2, n2 = comp_cost(cname)
                    flops += mult * f2
                    hbm += mult * h2
                    coll += mult * c2
                    for k, v in b2.items():
                        by_op[k] = by_op.get(k, 0.0) + mult * v
                    for k, v in n2.items():
                        cnt_op[k] = cnt_op.get(k, 0.0) + mult * v
        memo[name] = (flops, hbm, coll, by_op, cnt_op)
        return memo[name]

    f, h, c, b, n = comp_cost(entry)
    cost.flops = f
    cost.hbm_bytes = h
    cost.collective_bytes = c
    cost.bytes_by_op = {k: int(v) for k, v in b.items()}
    cost.count_by_op = {k: int(v) for k, v in n.items()}
    return cost
