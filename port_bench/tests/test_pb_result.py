"""A whole run on the CPU (the look for a card skipped, the program's plain
tensor path): the result line has the contract's keys, the checks come
last, and each metric reader reads what it should or nothing."""

import json
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT, small_cell

from pbench.runner import load_metric, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["wiki-repair-fused.paper-mix",
                                      "wiki-vbyte-dense.paper-mix"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(trace, workload):
    cell = small_cell(workload, batch=24 if trace else 96, n_articles=2, versions=3, words=40)
    result, lines = run_cell(ROOT, cell, 2**31 + 7, 0.2, bool(trace), "cpu",
                             time.perf_counter())
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["host", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"] == {"mismatched_answers": {"value": 0, "limit": 0}}
    assert lines[-1] == "check mismatched_answers: 0 (limit 0)"
    wanted = cell.per_layer if trace else cell.end_to_end
    on_cpu = {"device_mem_pct", "device_us_per_window", "window_roofline_pct",
              "device_idle_pct", "d2h_copy_us_per_window"}  # nothing to read on the CPU
    assert set(result["metrics"]) == {m["name"] for m in wanted} - on_cpu
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert 0 < result["host"]["window_cpu_s"] and 0 < result["host"]["window_s"]
    json.dumps(result)
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])


class _Run:
    counters, spans, trace = {}, {}, None
    window_s = window_cpu_s = window_queries = collection_bytes = index_device_bytes = 0
    device_held_bytes = None


@pytest.mark.parametrize("name", ["device_us_per_window", "window_roofline_pct",
                                  "device_idle_pct", "device_mem_pct", "host_routed_pct",
                                  "d2h_copy_us_per_window",
                                  "windows_per_kquery", "queries_per_s",
                                  "queries_per_s.dense",
                                  "index_device_pct"])
def test_reader_reads_nothing_as_none(name):
    assert load_metric(name).read(_Run()) is None


def test_only_the_benchmark_fails(tmp_path):
    """In a checkout of BENCHMARK.json and the benchmark's files alone, a run
    exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, str(tmp_path / BENCH.name / "run.py"), "--workload",
                        "wiki-repair-fused.paper-mix", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name,kind", [
    ("Memcpy DtoH (Device -> Pageable)", "d2h"), ("Memcpy DtoH (Device -> Pinned)", "d2h"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"), ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "fill"), ("probe_kernel<WindowProbes>", "kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "kernel")])
def test_trace_sorts_device_events(name, kind):
    """The kernels' time leaves copies and fills out; the engine's copy back
    is the device-to-host copies alone."""
    from pbench.trace import kind_of

    assert kind_of(name) == kind
