"""No module that the benchmark runs imports JAX, jaxlib, flax or the JAX
package ``repro`` (top-level names compared whole: ``repro_torch`` is the
program), and the yardstick (reference, traffic, collection, work, metrics)
imports nothing of the program."""

import ast
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the only modules that may touch the program
DRIVERS = {"pbench/program.py", "pbench/runner.py"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_source_imports(path):
    names = _top_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if str(path.relative_to(BENCH)) not in DRIVERS:
        assert "repro_torch" not in names


def test_loaded_modules_after_a_run_setup():
    """What the run loads in its own process (the program included)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pbench.program import import_program\n"
        "from pbench import runner, reference, traffic, work, trace, control\n"
        "import_program(__import__('pathlib').Path(%r))\n"
        "import repro_torch.serving.engine, repro_torch.kernels.fused_decode.ops\n"
        "import repro_torch.kernels.anchor_intersect.ops, torch.profiler\n"
        "print(sorted(runner.forbidden_modules()))\n" % (str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_is_by_whole_name():
    from pbench.runner import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.serving", "numpy"]) == set()
    assert forbidden_modules(["jaxlib.xla_client", "repro.core", "flax"]) == {
        "jaxlib", "repro", "flax"}
