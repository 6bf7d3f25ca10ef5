"""Shared set-up of the benchmark's tests: ``pbench`` on the path, the
``card`` marker, and a small cell to drive on the CPU."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip machine)")


def small_cell(workload: str, batch: int = 96, n_articles: int = 3, versions: int = 4,
               words: int = 60):
    """``workload``'s cell cut to a collection and batch a test can hold."""
    from pbench.runner import Cell, load_manifest

    cell = Cell.from_manifest(load_manifest(ROOT), workload, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config["collection"].update(n_articles=n_articles, versions_per_article=versions,
                                     words_per_doc=words)
    cell.mix = dict(cell.mix, batch=batch)
    return cell
