"""The port's drivers (``repro_torch.examples.*``, ``repro_torch.scripts.*``)
against the reference's own scripts, each run here with ``runpy``; the
port's on ``--device cpu``.

* quickstart, list_backends and explain (text and ``--json``) print the
  reference's lines;
* serve_queries and lifecycle_smoke print the same answers and stage lines
  (the lines that hold times excepted);
* recsys_retrieval, the reference's weights carried across, gives the same
  candidates and top-5;
* train_lm, the reference's initial state carried across, trains 3 steps
  with the reference's printed losses within §2's training limit of
  ``PERF.md`` for a float32 model, 2e-4 of max(1, |loss|) (printed to 3
  decimals, so 5e-4 more), and resumes from its checkpoint at its step;
* ``list_backends --require`` with no match exits 2, and smoke runs every
  stage.
"""

import dataclasses
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import steps as ref_steps
from repro.train.optimizer import OptConfig as RefOptConfig
from repro_torch.examples import quickstart, recsys_retrieval, serve_queries, train_lm
from repro_torch.models import recsys, steps
from repro_torch.scripts import explain, lifecycle_smoke, list_backends, smoke

ROOT = Path(__file__).resolve().parent.parent
TIMED = re.compile(r"\d+(\.\d+)? ?ms|mean step \d+ ms")


def _ref(capsys, script: str, *argv: str):
    """Runs the reference's ``script`` as ``__main__`` with ``argv``:
    ``(exit code, stdout, stderr)``."""
    capsys.readouterr()
    saved = sys.argv
    sys.argv = [str(ROOT / script), *argv]
    code = 0
    try:
        runpy.run_path(str(ROOT / script), run_name="__main__")
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = saved
    out = capsys.readouterr()
    return code, out.out, out.err


def _port(capsys, main, *argv: str):
    capsys.readouterr()
    code = main(list(argv))
    out = capsys.readouterr()
    return code, out.out, out.err


def _untimed(text: str) -> list[str]:
    return [TIMED.sub("<t>", line) for line in text.splitlines()]


def test_quickstart_prints_the_reference_lines(capsys):
    _, ref, _ = _ref(capsys, "examples/quickstart.py")
    _, port, _ = _port(capsys, quickstart.main)
    assert port == ref


@pytest.mark.parametrize("argv", [[], ["--family", "selfindex"], ["--family", "inverted"],
                                  ["--require", "persist"], ["--require", "persist,seek"],
                                  ["--require", "referential"]])
def test_list_backends_prints_the_reference_table(capsys, argv):
    """One difference, by design: the port's ``rlz`` build takes the
    caller's ``device`` (it signs its lists there), so its build kwargs
    column reads ``device=?`` where the reference's reads ``-``."""
    rc, ref, _ = _ref(capsys, "scripts/list_backends.py", *argv)
    code, port, _ = _port(capsys, list_backends.main, *argv)
    assert code == rc == 0
    rlz = [i for i, line in enumerate(ref.splitlines()) if line.startswith("rlz ")]
    want = ref.splitlines()
    for i in rlz:
        want[i] = want[i].replace(" -                  referential",
                                  " device=?           referential")
    assert port.splitlines() == want


@pytest.mark.parametrize("argv", [["--require", "referential,shifted_intersect"],
                                  ["--family", "selfindex", "--require", "device_resident"],
                                  ["--require", "no_such_capability"]])
def test_list_backends_require_without_match_exits_2(capsys, argv):
    rc, ref, ref_err = _ref(capsys, "scripts/list_backends.py", *argv)
    code, port, err = _port(capsys, list_backends.main, *argv)
    assert code == rc == 2
    assert (port, err) == (ref, ref_err) and "error:" in err


@pytest.mark.parametrize("argv", [["top5: alpha beta", "--store", "repair_skip"],
                                  ["--sample", "docs-phrase", "--store", "rlcsa", "--json"],
                                  ["--sample", "phrase"], ["--sample", "and", "--no-device"],
                                  ["--sample", "topk", "--json"], ["--operators"]])
def test_explain_prints_the_reference_plan(capsys, argv):
    _, ref, _ = _ref(capsys, "scripts/explain.py", *argv)
    _, port, _ = _port(capsys, explain.main, *argv, "--device", "cpu")
    assert port == ref


def test_serve_queries_gives_the_reference_answers(capsys):
    _, ref, _ = _ref(capsys, "examples/serve_queries.py")
    capsys.readouterr()
    got = serve_queries.main(["--device", "cpu"])
    port = capsys.readouterr().out
    assert _untimed(port) == _untimed(ref)
    assert "host/device agreement: 32/32 queries" in port
    assert all(np.array_equal(np.asarray(h), np.asarray(d))
               for h, d in zip(got["host"], got["device"]))


def test_lifecycle_smoke_prints_the_reference_stages(capsys, tmp_path):
    rc, ref, _ = _ref(capsys, "scripts/lifecycle_smoke.py", str(tmp_path / "ref"))
    code, port, _ = _port(capsys, lifecycle_smoke.main, str(tmp_path / "port"),
                          "--device", "cpu")
    assert code == rc == 0
    assert port == ref
    assert len(port.splitlines()) == 4 and "detected and named" in port


def test_recsys_retrieval_with_reference_weights(capsys):
    _, ref, _ = _ref(capsys, "examples/recsys_retrieval.py")
    ref_cfg = ref_get_config("two-tower-retrieval").reduced()
    ref_cfg = dataclasses.replace(ref_cfg, n_items=5000, n_users=1000)
    ref_params = ref_steps.init_model_params(ref_cfg, jax.random.PRNGKey(0))
    params = recsys.recsys_params_from_reference(
        recsys_retrieval.retrieval_config(), jax.tree.map(np.asarray, ref_params), "cpu")
    capsys.readouterr()
    got = recsys_retrieval.main(["--device", "cpu"], params=params)
    port = capsys.readouterr().out
    assert _untimed(port) == _untimed(ref)
    top = re.search(r"top-5 items (\[.*\])", ref).group(1)
    assert str(got["top5"].tolist()) == top
    assert "candidates after index pre-filter" in port


def test_train_lm_from_the_reference_state_and_resume(capsys, tmp_path):
    argv = ["--steps", "3", "--batch", "2", "--seq", "32"]
    _, ref, _ = _ref(capsys, "examples/train_lm.py", *argv, "--ckpt-dir", str(tmp_path / "r"))
    first, last = map(float, re.search(r"loss: ([\d.]+) -> ([\d.]+) over 3 steps", ref).groups())

    cfg = train_lm.lm_config()
    ref_cfg = ref_get_config("granite-3-2b")
    ref_cfg = dataclasses.replace(ref_cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                                  head_dim=64, d_ff=1536, vocab_size=49155, dtype="float32")
    ref_state = ref_steps.init_state(ref_steps.init_model_params(ref_cfg, jax.random.PRNGKey(0)),
                                     RefOptConfig(kind="adamw", lr=3e-4, warmup_steps=30,
                                                  total_steps=3))
    state = steps.train_state_from_reference(cfg, jax.tree.map(np.asarray, ref_state), "cpu")
    del ref_state
    ck = str(tmp_path / "p")
    capsys.readouterr()
    got = train_lm.main([*argv, "--ckpt-dir", ck, "--ckpt-every", "2", "--device", "cpu"],
                        state=state)
    port = capsys.readouterr().out
    losses = [l["loss"] for l in got["logs"]]
    for got_loss, printed in ((losses[0], first), (losses[-1], last)):
        # §2's float32 training limit, plus the printed value's rounding
        assert abs(got_loss - printed) <= 2e-4 * max(1.0, abs(printed)) + 5e-4
    assert [l["step"] for l in got["logs"]] == [0, 1, 2] and got["start"] == 0
    assert got["ckpt_steps"] == [2]
    assert "model: 75.5M params" in port and "checkpoints in" in port

    again = train_lm.main(["--steps", "1", "--batch", "2", "--seq", "32", "--ckpt-dir", ck,
                           "--device", "cpu"])
    assert again["start"] == 2 and [l["step"] for l in again["logs"]] == [2]


def test_smoke_runs_every_stage(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for stage in ("== backend registry ==", "inverted/self-index answers agree",
                  "== explain CLI", "checksum gate OK", "version mining OK",
                  "host/device agreement: 32/32 queries", "smoke OK"):
        assert stage in out, stage


def test_drivers_default_to_the_card(monkeypatch):
    """Without a GPU the default ``--device cuda`` raises by name; nothing
    falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((serve_queries.main, []), (recsys_retrieval.main, []),
                       (train_lm.main, ["--steps", "1"]), (smoke.main, []),
                       (lifecycle_smoke.main, ["unused"]), (explain.main, ["--sample", "and"])):
        with pytest.raises(RuntimeError, match="is_available"):
            main(argv)
