"""The one place the benchmark touches the program (``repro_torch``): the
builds, the session and the counters it reads.  The spans are the
benchmark's own, around the calls into each layer."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from .work import Layout


class ProgramMissing(RuntimeError):
    pass


def import_program(root: Path):
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise ProgramMissing(f"the program is not in this checkout ({src / 'repro_torch'})")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from repro_torch.core.index import NonPositionalIndex, PositionalIndex
    from repro_torch.serving.session import Session

    return NonPositionalIndex, PositionalIndex, Session


class Deployment:
    """A configuration's two indexes and its session on ``device``."""

    def __init__(self, root: Path, cfg: dict, docs: list[str], device: str):
        NonPositionalIndex, PositionalIndex, Session = import_program(root)
        stores = cfg["stores"]
        t0 = time.perf_counter()
        self.index = NonPositionalIndex.build(docs, store=stores["nonpositional"], device=device)
        self.positional = PositionalIndex.build(docs, store=stores["positional"], device=device)
        t1 = time.perf_counter()
        self.session = Session.build(self.index, positional=self.positional, device=device,
                                     layout=cfg["layout"], expand_len=int(cfg["expand_len"]))
        t2 = time.perf_counter()
        self.spans = {"index_build_s": t1 - t0, "session_build_s": t2 - t1}
        self.servers = [s for s in (self.session.server, self.session.positional_server)
                        if s is not None]
        layouts = {s.layout for s in self.servers}
        if len(self.servers) != 2 or layouts != {cfg["expect_layout"]}:
            raise RuntimeError(f"the configuration states two {cfg['expect_layout']} servers, "
                               f"the session built {len(self.servers)} of layouts {layouts}")

    def execute(self, texts: list[str]):
        return self.session.execute(texts)

    def windows_swept(self) -> int:
        return sum(s.windows_swept for s in self.servers)

    def device_bytes(self) -> int:
        return sum(s.device_bytes() for s in self.servers)

    def routes(self, texts: list[str]) -> list[str]:
        return [self.session.plan(t).route for t in texts]

    def device_groups(self, texts: list[str]):
        """The device groups one ``execute`` of ``texts`` sweeps, as the
        session forms them: (server, kind, encoded terms, lengths, known)."""
        from repro_torch.serving.plan import PHRASE, parse_query

        groups: dict[tuple, list[list[str]]] = {}
        for text in texts:
            pq = parse_query(text)
            rt = self.session.plan(pq)
            if rt.route == "device":
                groups.setdefault((rt.index, pq.kind, pq.k, pq.phrase, rt.width),
                                  []).append(list(pq.terms))
        out = []
        for (index_name, kind, _k, _phrase, width), terms in groups.items():
            server = (self.session.server if index_name == "nonpositional"
                      else self.session.positional_server)
            qt, ql, ok = server.encode(terms, sort_by_length=kind != PHRASE, width=width)
            out.append((server, kind == PHRASE, qt, ql, ok))
        return out

    def layout(self, server, ref) -> Layout:
        """The server's entry structure, with the reference's postings of each
        of its terms (documents for the word index, offsets for the
        positional one)."""
        fused = server.layout == "fused"
        c_off = server.arrays["c_offsets"].cpu().numpy().astype(np.int64)
        if fused:
            lanes = server.arrays["c_len"].cpu().numpy().astype(np.int64)
            width = max(int(server.max_phrase), 1)
        else:
            lanes = server.arrays["expand_valid"].sum(dim=1).cpu().numpy().astype(np.int64)
            width = int(server.arrays["expand"].shape[1])
        of = ref.docs_of if server.host_index is self.index else ref.positions_of
        lists = [of(tok) for tok in server.host_index.vocab.id_to_token]
        return Layout(c_off, lanes, width, fused, lists)
