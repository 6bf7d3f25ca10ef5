"""Self-indexes (paper Appendix A) + the SearchBackend adapter that puts
them behind the same query protocol as the inverted list stores."""

from .csa import RLCSA, WCSA
from .lzidx import LZ77Index, LZEndIndex, LZSelfIndex
from .slp import SLPIndex, WSLPIndex

__all__ = ["RLCSA", "WCSA", "LZ77Index", "LZEndIndex", "LZSelfIndex",
           "SLPIndex", "WSLPIndex", "SelfIndexBackend"]


def __getattr__(name):  # lazy: adapter imports codecs.base, keep csa/lzidx light
    if name == "SelfIndexBackend":
        from .adapter import SelfIndexBackend

        return SelfIndexBackend
    raise AttributeError(name)
