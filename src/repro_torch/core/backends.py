"""Built-in backend registrations (imported lazily by ``core.registry``).

One ``@register_backend`` per backend, with the paper section, the benchmark
group (``traditional`` = §2 baselines, ``ours`` = §3–4 methods,
``selfindex`` = Appendix A), and the declared capability set.  Build
functions take a :class:`~repro_torch.core.registry.BuildSource` plus explicit
keyword arguments; the registry validates names and kwargs, so an unknown
store or a stray kwarg is a clear ``ValueError``.

All 24 backends of the reference, in its order.  Every build runs on the
host except ``rlz``, whose build signs the lists on the ``device`` it is
given.  The Re-Pair family is device-resident (its grammar arrays anchor
straight onto the device); the batched server re-anchors every other
inverted store from its decoded lists; the self-indexes get no device server.
"""

from __future__ import annotations

from .codecs import (
    EliasFano,
    Interpolative,
    OptPFD,
    PartitionedEF,
    PerListStore,
    PForDelta,
    Rice,
    RiceRuns,
    Simple9,
    VByte,
    VbyteLZMA,
)
from .lz_store import VbyteLZendStore
from .registry import (
    CAP_DEVICE_RESIDENT,
    CAP_DOC_LIST,
    CAP_EXTRACT,
    CAP_INTERSECT_CANDIDATES,
    CAP_REFERENTIAL,
    CAP_SEEK,
    CAP_SHIFTED_INTERSECT,
    FAMILY_INVERTED,
    FAMILY_SELFINDEX,
    BuildSource,
    register_backend,
)
from .repair import RePairStore
from .rlz_store import RLZStore
from .sampled_store import SampledVByteStore
from .selfindex import LZ77Index, LZEndIndex, RLCSA, WCSA
from .selfindex.adapter import SelfIndexBackend

SELFINDEX_CAPS = (CAP_SHIFTED_INTERSECT, CAP_EXTRACT, CAP_DOC_LIST)


# ----------------------------------------------------------------------
# per-list codecs (§2.2 baselines + §3.1/§3.2)
# ----------------------------------------------------------------------
def _per_list(name: str, codec_cls, group: str, paper: str, doc: str):
    @register_backend(name, family=FAMILY_INVERTED, group=group, paper=paper, doc=doc)
    def build(source: BuildSource):
        return PerListStore.build(source.lists, codec=codec_cls())

    return build


_per_list("vbyte", VByte, "traditional", "§2.2", "per-list Vbyte gap coding")
_per_list("rice", Rice, "traditional", "§2.2", "per-list Rice codes")
_per_list("rice_runs", RiceRuns, "ours", "§3.1", "Rice + run-length of gap=1 runs")
_per_list("simple9", Simple9, "traditional", "§2.2", "Simple9 word-aligned packing")
_per_list("pfordelta", PForDelta, "traditional", "§2.2", "PForDelta (patched frame-of-reference)")
_per_list("opt_pfd", OptPFD, "traditional", "§2.2", "OptPFD (per-block optimized PFD)")
_per_list("elias_fano", EliasFano, "traditional", "§2.2", "Elias-Fano monotone sequences")
_per_list("ef_opt", PartitionedEF, "traditional", "§2.2", "partitioned Elias-Fano")
_per_list("interpolative", Interpolative, "traditional", "§2.2", "binary interpolative coding")
_per_list("vbyte_lzma", VbyteLZMA, "ours", "§3.2", "Vbyte then LZMA per list (flagged)")


# ----------------------------------------------------------------------
# sampled Vbyte (§2.2 [21]/[60]) — seek + compressed-domain candidates
# ----------------------------------------------------------------------
@register_backend("vbyte_cm", family=FAMILY_INVERTED, group="traditional", paper="§2.2 [21]",
                  capabilities=(CAP_SEEK, CAP_INTERSECT_CANDIDATES),
                  doc="Vbyte + Culpepper-Moffat samples")
def build_vbyte_cm(source: BuildSource, k: int = 32):
    return SampledVByteStore.build(source.lists, kind="cm", param=k)


@register_backend("vbyte_st", family=FAMILY_INVERTED, group="traditional", paper="§2.2 [60]",
                  capabilities=(CAP_SEEK, CAP_INTERSECT_CANDIDATES),
                  doc="Vbyte + Transier-Sanders domain sampling")
def build_vbyte_st(source: BuildSource, B: int = 16):
    return SampledVByteStore.build(source.lists, kind="st", param=B)


@register_backend("vbyte_cmb", family=FAMILY_INVERTED, group="traditional", paper="§2.2",
                  capabilities=(CAP_SEEK, CAP_INTERSECT_CANDIDATES),
                  doc="vbyte_cm + bitmaps for long lists")
def build_vbyte_cmb(source: BuildSource, k: int = 32):
    return SampledVByteStore.build(source.lists, kind="cm", param=k, bitmaps=True)


@register_backend("vbyte_stb", family=FAMILY_INVERTED, group="traditional", paper="§2.2",
                  capabilities=(CAP_SEEK, CAP_INTERSECT_CANDIDATES),
                  doc="vbyte_st + bitmaps for long lists")
def build_vbyte_stb(source: BuildSource, B: int = 16):
    return SampledVByteStore.build(source.lists, kind="st", param=B, bitmaps=True)


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
# global LZ-End store (§3.3)
# ----------------------------------------------------------------------
@register_backend("vbyte_lzend", family=FAMILY_INVERTED, group="ours", paper="§3.3",
                  doc="global LZ-End over concatenated Vbyte stream")
def build_vbyte_lzend(source: BuildSource):
    return VbyteLZendStore.build(source.lists)


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


# ----------------------------------------------------------------------
# self-indexes (Appendix A) — token-stream backends behind the same API.
# Restore hooks rebuild the inner index from the persisted token stream
# (the stream itself is exported by `to_arrays` via the self-index
# extract property, so no stored text is ever required).
# ----------------------------------------------------------------------
@register_backend("rlcsa", family=FAMILY_SELFINDEX, group="selfindex", paper="App. A.1",
                  capabilities=SELFINDEX_CAPS,
                  doc="run-length CSA over the token-id stream",
                  restore=lambda arrays, sample_rate=64:
                      SelfIndexBackend.from_arrays(arrays, RLCSA,
                                                   sample_rate=sample_rate))
def build_rlcsa(source: BuildSource, sample_rate: int = 64):
    return SelfIndexBackend.build(source, RLCSA, sample_rate=sample_rate)


@register_backend("wcsa", family=FAMILY_SELFINDEX, group="selfindex", paper="App. A.1",
                  capabilities=SELFINDEX_CAPS,
                  doc="word-level CSA over the token-id stream",
                  restore=lambda arrays, sample_rate=64:
                      SelfIndexBackend.from_arrays(arrays, WCSA,
                                                   sample_rate=sample_rate))
def build_wcsa(source: BuildSource, sample_rate: int = 64):
    return SelfIndexBackend.build(source, WCSA, sample_rate=sample_rate)


@register_backend("lz77_idx", family=FAMILY_SELFINDEX, group="selfindex", paper="App. A.3",
                  capabilities=SELFINDEX_CAPS,
                  doc="LZ77 self-index over the token-id stream",
                  restore=lambda arrays:
                      SelfIndexBackend.from_arrays(arrays, LZ77Index))
def build_lz77_idx(source: BuildSource):
    return SelfIndexBackend.build(source, LZ77Index)


@register_backend("lzend_idx", family=FAMILY_SELFINDEX, group="selfindex", paper="App. A.3",
                  capabilities=SELFINDEX_CAPS,
                  doc="LZ-End self-index over the token-id stream",
                  restore=lambda arrays:
                      SelfIndexBackend.from_arrays(arrays, LZEndIndex))
def build_lzend_idx(source: BuildSource):
    return SelfIndexBackend.build(source, LZEndIndex)
