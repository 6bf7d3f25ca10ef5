"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds its
configuration, mix, reference kinds and metric readers by name."""

import json
import re

import pytest
from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(MANIFEST) == KEYS
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MANIFEST["paths"])
            assert (ROOT / w).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"].startswith("port_bench/") and (ROOT / cfg["file"]).is_file()
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    assert sorted(cfg["reduced"]) == sorted(body["reduced"])
    assert all(k in body["collection"] for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in MANIFEST["workloads"])
    others = [c for c in MANIFEST["configs"] if c is not cfg]
    assert all(c["file"] != cfg["file"] and c["source"] != cfg["source"] for c in others)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    from pbench.reference import REFERENCE_DIR
    from pbench.runner import Cell, METRICS_DIR

    w = {x["name"]: x for x in MANIFEST["workloads"]}[workload]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    cell = Cell.from_manifest(MANIFEST, workload, ROOT)
    for e in cell.mix["queries"]:
        assert (REFERENCE_DIR / f"{e['kind']}.py").is_file()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert (METRICS_DIR / f"{m['name']}.py").is_file()
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    e2e = metric in MANIFEST["end_to_end"]
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert set(metric) <= allowed and NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert _line(metric["layer"]) and metric["moves"] in {
            m["name"] for m in MANIFEST["end_to_end"]}
        assert metric["workloads"]
    assert all(c in CELLS for c in metric.get("workloads", []))
    if metric["name"] == "setup_s":
        assert metric["bound"] <= 0.25


@pytest.mark.parametrize("key", ["mining", "params"])
def test_config_key_nothing_reads_is_refused(tmp_path, key):
    """A configuration that sets a key the runner does not act on is refused,
    so a setting never silently changes nothing."""
    from pbench.runner import Cell

    cfg = MANIFEST["configs"][0]
    body = json.loads((ROOT / cfg["file"]).read_text())
    body[key] = True
    (tmp_path / cfg["file"]).parent.mkdir(parents=True)
    (tmp_path / cfg["file"]).write_text(json.dumps(body))
    workload = next(w["name"] for w in MANIFEST["workloads"] if w["config"] == cfg["name"])
    with pytest.raises(ValueError, match="nothing reads"):
        Cell.from_manifest(MANIFEST, workload, tmp_path)


def test_mix_key_nothing_reads_is_refused(tmp_path, monkeypatch):
    from pbench import traffic

    mix = json.loads((BENCH / "traffic" / "paper-mix.json").read_text())
    mix["queries"][0]["k"] = 10
    (tmp_path / "extra.json").write_text(json.dumps(mix))
    monkeypatch.setattr(traffic, "TRAFFIC_DIR", tmp_path)
    with pytest.raises(ValueError, match="nothing reads"):
        traffic.load_mix("extra")
