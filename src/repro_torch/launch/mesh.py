"""Production and local meshes (``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group and no device.
"""

from __future__ import annotations

from ..sharding.compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over the current world, which must hold
    256 or 512 ranks (under the ``fake`` backend one process stands for
    them all)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    """Axes used for data parallelism (batch sharding)."""
    return ("pod", "data") if multi_pod else ("data",)


def make_local_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda"):
    """An ``(n_data, n_model)`` ``("data", "model")`` mesh over the current
    world (``n_data * n_model`` ranks)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type=device_type)
