"""The PyTorch package stands alone: importing it, any module of it, or
``chip_smoke.py`` pulls in neither ``jax`` nor the JAX package ``repro``."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _module_names() -> list[str]:
    names = ["repro_torch"]
    for m in pkgutil.walk_packages([str(SRC / "repro_torch")], prefix="repro_torch."):
        names.append(m.name)
    return sorted(names)


MODULES = _module_names()


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT),
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


def test_module_list_covers_the_slice():
    for needed in ("repro_torch.core.anchors", "repro_torch.serving.engine",
                   "repro_torch.serving.session", "repro_torch.kernels.cuda_build",
                   "repro_torch.kernels.anchor_intersect.ops",
                   "repro_torch.kernels.fused_decode.ops", "repro_torch.data.queries",
                   "repro_torch.core.device", "repro_torch.core.similarity",
                   "repro_torch.core.similarity.minhash",
                   "repro_torch.core.similarity.cluster", "repro_torch.core.rlz_store",
                   "repro_torch.core.codecs.bitio", "repro_torch.kernels.minhash_sig.ops",
                   "repro_torch.kernels.minhash_sig.ref", "repro_torch.kernels",
                   "repro_torch.kernels.dgap_decode.ops", "repro_torch.kernels.dgap_decode.ref",
                   "repro_torch.kernels.anchor_intersect.ref",
                   "repro_torch.core.backends", "repro_torch.core.sampled_store",
                   "repro_torch.core.suffix", "repro_torch.core.lz",
                   "repro_torch.core.lz_store", "repro_torch.core.selfindex",
                   "repro_torch.core.selfindex.adapter", "repro_torch.core.selfindex.csa",
                   "repro_torch.core.selfindex.lzidx", "repro_torch.core.selfindex.slp",
                   *(f"repro_torch.core.codecs.{m}" for m in (
                       "rice", "simple9", "pfordelta", "elias_fano", "interpolative",
                       "elias", "lz_codecs")),
                   "repro_torch.configs", "repro_torch.configs.base",
                   "repro_torch.configs.archs", "repro_torch.data.pipelines",
                   "repro_torch.models", "repro_torch.models.layers",
                   "repro_torch.models.flash", "repro_torch.models.transformer",
                   "repro_torch.models.steps", "repro_torch.kernels.flash_attention",
                   "repro_torch.kernels.flash_attention.ops",
                   "repro_torch.kernels.flash_attention.ref",
                   "repro_torch.kernels.flash_decode", "repro_torch.kernels.flash_decode.ops",
                   "repro_torch.kernels.flash_decode.ref", "repro_torch.models.recsys",
                   *(f"repro_torch.kernels.{k}{m}" for k in (
                       "embedding_bag", "cin_interaction", "moe_gemm")
                     for m in ("", ".ops", ".ref")),
                   "repro_torch.core.artifact", "repro_torch.core.writer",
                   "repro_torch.core.storage", "repro_torch.core.storage.blobstore",
                   "repro_torch.core.storage.compaction",
                   "repro_torch.core.storage.mapped", "repro_torch.data.synthetic",
                   "repro_torch.serving.frontend", "repro_torch.serving.partitioned",
                   "repro_torch.launch", "repro_torch.launch.serve",
                   "repro_torch.train", "repro_torch.train.optimizer",
                   "repro_torch.train.loop", "repro_torch.checkpoint",
                   "repro_torch.checkpoint.checkpointer", "repro_torch.models.gnn",
                   "repro_torch.models.segment", "repro_torch.data.graphs",
                   "repro_torch.launch.train", "repro_torch.sharding",
                   "repro_torch.sharding.compat", "repro_torch.sharding.specs",
                   "repro_torch.sharding.spmd", "repro_torch.launch.mesh",
                   "repro_torch.train.grad_compression",
                   *(f"repro_torch.launch.{m}" for m in (
                       "dryrun", "hlo_cost", "hlo_analysis", "roofline")),
                   "repro_torch.examples", "repro_torch.scripts",
                   *(f"repro_torch.examples.{m}" for m in (
                       "quickstart", "serve_queries", "recsys_retrieval", "train_lm")),
                   *(f"repro_torch.scripts.{m}" for m in (
                       "list_backends", "explain", "lifecycle_smoke", "smoke"))):
        assert needed in MODULES, needed


def test_training_imports_build_no_kernel():
    """The optimisers, the loop, the checkpointer, the GIN and the training
    driver import without ``jax`` or ``repro`` and build no kernel."""
    code = (
        "import sys\n"
        "import repro_torch.train.optimizer, repro_torch.train.loop\n"
        "import repro_torch.checkpoint.checkpointer, repro_torch.models.gnn\n"
        "import repro_torch.launch.train\n"
        "from repro_torch.kernels import cuda_build\n"
        "assert cuda_build._lib is None and not cuda_build.build_info\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_serving_frontier_imports_build_no_kernel():
    """The frontend, the partitioned server and the serving driver import
    without ``jax`` or ``repro`` and build no kernel at import."""
    code = (
        "import sys\n"
        "import repro_torch.serving.frontend, repro_torch.serving.partitioned\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.kernels import cuda_build\n"
        "assert cuda_build._lib is None and not cuda_build.build_info\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_mesh_tier_imports_touch_no_process_group():
    """The mesh tier (meshes, specs, the sharded step, gradient compression)
    and the modules that now accept a mesh import without ``jax`` or
    ``repro``, build no kernel and start no process group."""
    code = (
        "import sys\n"
        "import repro_torch.sharding.compat, repro_torch.sharding.specs\n"
        "import repro_torch.sharding.spmd, repro_torch.launch.mesh\n"
        "import repro_torch.train.grad_compression, repro_torch.serving.partitioned\n"
        "import repro_torch.checkpoint.checkpointer\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.kernels import cuda_build\n"
        "assert cuda_build._lib is None and not cuda_build.build_info\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_dryrun_and_drivers_import_touch_nothing():
    """The dry-run tier and the drivers import without ``jax`` or
    ``repro``, build no kernel, start no process group and touch no CUDA."""
    code = (
        "import sys\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "import repro_torch.launch.hlo_cost, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.serve_queries\n"
        "import repro_torch.examples.recsys_retrieval, repro_torch.examples.train_lm\n"
        "import repro_torch.scripts.smoke\n"
        "import torch, torch.distributed as dist\n"
        "assert not dist.is_initialized() and not torch.cuda.is_initialized()\n"
        "from repro_torch.kernels import cuda_build\n"
        "assert cuda_build._lib is None and not cuda_build.build_info\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"names = {MODULES!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('ok', len(names))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("name", MODULES)
def test_module_source_names_no_jax_import(name):
    """Static half of the same claim, per module (one case each)."""
    rel = Path(*name.split("."))
    path = SRC / rel / "__init__.py" if (SRC / rel).is_dir() else SRC / rel.with_suffix(".py")
    text = path.read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert not s.startswith(("import jax", "from jax", "import repro ",
                                     "import repro.", "from repro ", "from repro.")), (name, s)


def test_chip_smoke_imports_without_jax_or_repro():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device here: the script must exit non-zero and print no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
