"""One run of one cell: set-up, the measured window, the traced batches, the
check against the reference, and the result line.

``run_cell`` does everything but the look for a card, so a test can drive a
whole run on the CPU (with a small configuration and the program's plain
tensor path); ``port_bench/run.py`` is the command, which looks for the
card first.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import collection
from .reference import Reference, RefIndex
from .traffic import Traffic, load_mix, tokens_of

BENCH_DIR = Path(__file__).resolve().parent.parent
METRICS_DIR = BENCH_DIR / "metrics"
#: batches traced in a ``--trace 1`` run, after the measured window
TRACE_BATCHES = 3
#: the batch span the harness puts around each traced ``execute``
BATCH_SPAN = "port_bench.batch"
#: top-level module names that no run may have loaded once its window closes
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: the keys a configuration file may hold: what the runner acts on, and the
#: descriptive ``name``, ``source``, ``deployment``, ``reduced``, ``assumed``
CONFIG_KEYS = frozenset({"name", "source", "deployment", "collection", "stores", "layout",
                         "expect_layout", "expand_len", "guarantees", "reduced", "assumed"})
#: the guarantees the runner holds a run to: every answer equal to the
#: reference's (the limit 0), and an index that nothing writes to
GUARANTEES = {"answers": "exact", "index": "read-only"}


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def from_manifest(cls, manifest: dict, workload: str, root: Path) -> "Cell":
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; the cells are {sorted(cells)}")
        w = cells[workload]
        entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        config = json.loads((root / entry["file"]).read_text())
        extra = set(config) - CONFIG_KEYS
        if extra or config.get("name") != entry["name"]:
            raise ValueError(f"{entry['file']}: keys that nothing reads {sorted(extra)}, or a "
                             f"name other than {entry['name']!r}")
        if config.get("guarantees") != GUARANTEES:
            raise ValueError(f"{entry['file']}: the runner holds a run to {GUARANTEES} only")
        applies = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
        return cls(workload, config, load_mix(w["traffic"]),
                   [m for m in manifest["end_to_end"] if applies(m)],
                   [m for m in manifest["per_layer"] if applies(m)])


def load_metric(name: str):
    """The reader of one metric (``metrics/<name>.py``)."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """What one run measured and counted; the metric readers read it."""

    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    collection_bytes: int = 0
    index_device_bytes: int = 0
    device_held_bytes: int | None = None
    window_s: float = 0.0
    window_cpu_s: float = 0.0
    window_queries: int = 0
    host_probe: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: dict | None = None
    traced_batches: list = field(default_factory=list)
    deployment: object = None
    ref: object = None

    def window_least_seconds(self) -> tuple[float, int]:
        """Least seconds of every window the traced batches swept, summed
        (``pbench.work``), and the number of windows."""
        from .work import group_least_seconds

        layouts: dict[int, object] = {}
        total, windows = 0.0, 0
        for texts in self.traced_batches:
            for server, phrase, qt, ql, ok in self.deployment.device_groups(texts):
                if id(server) not in layouts:
                    layouts[id(server)] = self.deployment.layout(server, self.ref)
                s, n = group_least_seconds(layouts[id(server)], qt, ql, ok, phrase)
                total, windows = total + s, windows + n
        return total, windows


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _device_used(device: str) -> int | None:
    """Bytes in use on the card by the device's own count (``cudaMemGetInfo``:
    total less free), or None off a card."""
    if not device.startswith("cuda"):
        return None
    import torch

    free, total = torch.cuda.mem_get_info()
    return int(total - free)




def host_probe() -> dict:
    """Seconds of two fixed loops on the host, run right after the window: one
    of Python bytecode on small ints and dicts (the serving loop's kind of
    work), one of random reads over 256 MiB (memory).  They read how fast
    the host ran just then, beside the window's rate; nothing is compared."""
    t = time.perf_counter()
    d: dict[int, int] = {}
    for i in range(2_000_000):
        d[i & 4095] = d.get(i & 4095, 0) + (i * i) % 7
    python_s = time.perf_counter() - t
    big = np.arange(1 << 26, dtype=np.int32)
    idx = np.random.default_rng(0).integers(0, 1 << 26, 1 << 23)
    t = time.perf_counter()
    int(big[idx].sum())
    memory_s = time.perf_counter() - t
    del big, idx
    return {"probe_python_s": python_s, "probe_memory_s": memory_s}


def compare(batches, answers, reference: Reference) -> tuple[int, int, int]:
    """(answers compared, answers that differ from the reference's, non-empty
    reference answers).  A batch that returned the wrong number of answers
    counts every query of it as differing."""
    compared = mismatched = nonempty = 0
    for queries, got in zip(batches, answers):
        if got is None or len(got) != len(queries):
            compared += len(queries)
            mismatched += len(queries)
            continue
        for q, a in zip(queries, got):
            want = reference.answer(q)
            compared += 1
            nonempty += len(want) > 0
            a = np.asarray(a)
            if a.shape != want.shape or not np.array_equal(a.astype(np.int64), want):
                mismatched += 1
    return compared, mismatched, nonempty


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> tuple[dict, list[str]]:
    """Run ``cell`` once; returns (the result object, the check lines for
    standard error).  ``t0`` is the process's start on the host clock."""
    from .program import Deployment

    seed = int(seed) % 2**64
    cfg = cell.config
    used_before = _device_used(device)  # the context's own bytes, before the program's
    docs = collection.generate(seed, **cfg["collection"])
    dep = Deployment(root, cfg, docs, device)
    run = Run(spans=dict(dep.spans), collection_bytes=sum(len(d) for d in docs),
              index_device_bytes=dep.device_bytes(), deployment=dep)
    tokens = tokens_of(docs)
    traffic = Traffic(cell.mix, tokens, seed)
    warm = [q.text for q in traffic.batch(0)]
    dep.execute(warm)  # the first call builds what the program builds on first use
    _sync(device)
    tw = time.perf_counter()
    dep.execute(warm)
    _sync(device)
    warm_s = time.perf_counter() - tw  # a warm batch, which sizes the pool
    pool = [traffic.batch(i) for i in range(1, 2 + math.ceil(2 * seconds / warm_s))]
    pool_texts = [[q.text for q in b] for b in pool]
    traced_pool = ([traffic.batch(len(pool) + 1 + j) for j in range(TRACE_BATCHES)]
                   if trace else [])
    gc.collect()  # no collection of the set-up's garbage falls due in the window
    cpu0 = time.process_time()
    t_start = time.perf_counter()
    run.setup_s = t_start - t0
    # the measured window: batches back to back, nothing else on the host
    w0 = dep.windows_swept()
    done, answers, ends = [], [], []
    n = 0
    while True:
        k = n % len(pool)
        answers.append(dep.execute(pool_texts[k]))
        done.append(k)
        n += 1
        ends.append(time.perf_counter())
        if ends[-1] - t_start >= seconds:
            break
    _sync(device)
    run.window_s = time.perf_counter() - t_start
    run.window_cpu_s = time.process_time() - cpu0
    run.host_probe = host_probe()
    took = np.diff([t_start] + ends)
    w1 = dep.windows_swept()
    run.window_queries = sum(len(pool_texts[k]) for k in done)
    batches = [pool[k] for k in done]
    if trace:
        run.traced_batches = [[q.text for q in b] for b in traced_pool]
        run.trace, traced = _traced(dep, run.traced_batches, device)
        batches += traced_pool
        answers += traced
    peak = None
    if device.startswith("cuda"):
        import torch

        peak = torch.cuda.max_memory_allocated()
        # what the deployment holds between batches: the allocator's cache of
        # freed blocks released, the card's own count less the context's
        torch.cuda.empty_cache()
        run.device_held_bytes = _device_used(device) - used_before
    routes = [r for k in done for r in dep.routes(pool_texts[k])]
    run.counters = {"queries": run.window_queries, "host_routed": routes.count("host"),
                    "windows": w1 - w0}
    # the reference, from the documents alone, once the window has closed
    run.ref = ref = RefIndex(docs, tokens)
    compared, mismatched, nonempty = compare(batches, answers, Reference(ref))
    checks = {"mismatched_answers": {"value": mismatched, "limit": 0}}
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": mismatched == 0 and compared > 0,
              "attempted": compared, "failed": mismatched, "metrics": metrics,
              "device": _device_block(device, peak, run.trace)}
    if trace and run.trace:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["host"] = {"window_s": run.window_s, "window_cpu_s": run.window_cpu_s,
                      "batch_s": [float(x) for x in took], **run.host_probe}
    result["checks"] = checks
    quartiles = " / ".join(f"{x:.4f}" for x in np.quantile(took, [0, .25, .5, .75, 1]))
    lines = [f"window: {len(done)} batches of a pool of {len(pool)}, warm-up {warm_s:.3f} s, "
             f"seconds a batch min / q1 / median / q3 / max {quartiles}",
             f"host: the process's CPU {run.window_cpu_s:.3f} s of the window's "
             f"{run.window_s:.3f} s; after it, the fixed loops took "
             + ", ".join(f"{k} {v:.4f} s" for k, v in run.host_probe.items()),
             f"compared {compared} answers ({nonempty} non-empty) of {len(batches)} batches",
             *(f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items())]
    return result, lines


def _traced(dep, batches: list[list[str]], device: str):
    """The given batches under the profiler, each in a span of its own;
    (the trace read, the answers of each batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import read_trace

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    out = []
    w0 = dep.windows_swept()
    with profile(activities=acts) as prof:
        for texts in batches:
            with record_function(BATCH_SPAN):
                out.append(dep.execute(texts))
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    summary = read_trace(prof, BATCH_SPAN)
    summary["windows"] = dep.windows_swept() - w0
    return summary, out


def forbidden_modules(names=None) -> set[str]:
    """Top-level names (the part before the first dot, whole) among the
    loaded modules (or ``names``) that the run may not hold."""
    return {n.split(".")[0] for n in (list(sys.modules) if names is None else names)} & FORBIDDEN


def _device_block(device: str, peak, trace) -> dict:
    if device.startswith("cuda"):
        import torch

        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                 "memory_peak_bytes": int(peak)}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        block["busy_s"] = trace.get("busy_s", 0.0)
        block["window_s"] = trace.get("window_s", 0.0)
    return block
