"""Built-in backend registrations (imported lazily by ``core.registry``).

One ``@register_backend`` per backend, with the paper section, the benchmark
group (``traditional`` = §2 baselines, ``ours`` = §3–4 methods) and the
declared capability set.  Build functions take a
:class:`~repro_torch.core.registry.BuildSource` plus explicit keyword
arguments; the registry validates names and kwargs, so an unknown store or a
stray kwarg is a clear ``ValueError``.

Registered here: the Re-Pair family (device-resident — their grammar arrays
anchor straight onto the device), per-list ``vbyte`` (the non-resident
representative: the batched server re-anchors it from decoded lists) and
``rlz`` (referential lists against MinHash-mined heads; its build signs the
lists on the ``device`` it is given).  Any other store name raises the
registry's ``ValueError`` listing these six.
"""

from __future__ import annotations

from .codecs import PerListStore, VByte
from .registry import (
    CAP_DEVICE_RESIDENT,
    CAP_DOC_LIST,
    CAP_INTERSECT_CANDIDATES,
    CAP_REFERENTIAL,
    CAP_SEEK,
    FAMILY_INVERTED,
    BuildSource,
    register_backend,
)
from .repair import RePairStore
from .rlz_store import RLZStore


# ----------------------------------------------------------------------
# per-list codecs (§2.2 baselines)
# ----------------------------------------------------------------------
@register_backend("vbyte", family=FAMILY_INVERTED, group="traditional", paper="§2.2",
                  doc="per-list Vbyte gap coding")
def build_vbyte(source: BuildSource):
    return PerListStore.build(source.lists, codec=VByte())


# ----------------------------------------------------------------------
# Re-Pair grammar stores (§4) — device-resident; skip variants intersect
# in the compressed domain, sampled variants also seek.  Their restore
# hooks reload the packed grammar arrays directly: restoring never re-runs
# Re-Pair compression (max_rules/k/B are already baked into the persisted
# grammar and samples are rebuilt from it).
# ----------------------------------------------------------------------
@register_backend("repair", family=FAMILY_INVERTED, group="ours", paper="§4",
                  capabilities=(CAP_DEVICE_RESIDENT, CAP_DOC_LIST),
                  doc="Re-Pair grammar over concatenated d-gap lists",
                  restore=lambda arrays, max_rules=None:
                      RePairStore.from_arrays(arrays, variant="plain"))
def build_repair(source: BuildSource, max_rules: int | None = None):
    return RePairStore.build(source.lists, variant="plain", max_rules=max_rules)


@register_backend("repair_skip", family=FAMILY_INVERTED, group="ours", paper="§4.1",
                  capabilities=(CAP_DEVICE_RESIDENT, CAP_INTERSECT_CANDIDATES, CAP_DOC_LIST),
                  doc="Re-Pair + skipping data (phrase sums)",
                  restore=lambda arrays, max_rules=None:
                      RePairStore.from_arrays(arrays, variant="skip"))
def build_repair_skip(source: BuildSource, max_rules: int | None = None):
    return RePairStore.build(source.lists, variant="skip", max_rules=max_rules)


@register_backend("repair_skip_cm", family=FAMILY_INVERTED, group="ours", paper="§4.2",
                  capabilities=(CAP_DEVICE_RESIDENT, CAP_INTERSECT_CANDIDATES, CAP_SEEK, CAP_DOC_LIST),
                  doc="Re-Pair skip + CM-style sampling",
                  restore=lambda arrays, k=64:
                      RePairStore.from_arrays(arrays, variant="skip",
                                              sampling=("cm", k)))
def build_repair_skip_cm(source: BuildSource, k: int = 64):
    return RePairStore.build(source.lists, variant="skip", sampling=("cm", k))


@register_backend("repair_skip_st", family=FAMILY_INVERTED, group="ours", paper="§4.2",
                  capabilities=(CAP_DEVICE_RESIDENT, CAP_INTERSECT_CANDIDATES, CAP_SEEK, CAP_DOC_LIST),
                  doc="Re-Pair skip + ST-style sampling",
                  restore=lambda arrays, B=1024:
                      RePairStore.from_arrays(arrays, variant="skip",
                                              sampling=("st", B)))
def build_repair_skip_st(source: BuildSource, B: int = 1024):
    return RePairStore.build(source.lists, variant="skip", sampling=("st", B))


# ----------------------------------------------------------------------
# RLZ referential store (§1 competitor) — the structure-aware counterpoint:
# version structure is mined (MinHash-LSH over the lists themselves), then
# each list is stored as a diff against its cluster head.  The mining runs a
# kernel, so the build takes the device from its caller: the index build
# passes its own, and the generic restore path (which rebuilds from decoded
# lists and so mines again) needs ``device=`` among its keywords.  A device
# is not part of an index and never lands in the persisted ``store_kw``.
# ----------------------------------------------------------------------
@register_backend("rlz", family=FAMILY_INVERTED, group="ours", paper="§1 (RLZ)",
                  capabilities=(CAP_REFERENTIAL,),
                  doc="referential lists vs MinHash-LSH mined cluster heads")
def build_rlz(source: BuildSource, *, device):
    return RLZStore.build(source.lists, device=device)
