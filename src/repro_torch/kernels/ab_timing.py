"""Time the port's redesigned kernels at the serving paths' shapes on one
CUDA card, for the ``repro_torch`` found first on ``sys.path``::

    python3 src/repro_torch/kernels/ab_timing.py [--src OTHER/src] [--reps N]
                                                 [--only index|model|attention]
                                                 [--windows FILE.npz]

``--src`` puts another checkout's ``src`` first, so two checkouts of the
port (say a commit and its parent) are timed by the same code on the same
card: run them in turns in one call (A B B A).  Inputs are random, seeded.

* index side: ``dgap_decode`` at the positional index's whole d-gap stream
  (1,603,481 values), its longest list (196,811) and a 4,096-value list,
  beside ``torch.cumsum``; where the checkout's wrapper has two load routes,
  the element-load route too (a view one element in).  Outputs equal the
  plain version.  With ``--windows`` (a file ``chip_smoke.py
  --save-windows`` writes: the fused servers' arrays and the serving path's
  phrase2 / and2 term batches, and the inputs of the mining and ``rlz``
  signature calls), one fused ``probe="kernel"`` serve step of the checkout
  on the first window of each batch: :func:`window_split`'s host ms, window
  ms, device ms and kernels a window, and a digest of its answers (equal
  across checkouts); and ``minhash_rows`` on the two recorded signature
  calls, equal to the plain version, with a digest of its output, and once
  more with every row's length 0 (``ms_no_live_lanes``: no hashing).
* model side: ``embedding_bag`` at xDeepFM's ``serve_bulk`` x0 lookup and
  linear term (the registry's table, seeded ids in each field's
  vocabulary), ``flash_decode`` and ``cin_layer`` at the LM and recsys
  serving paths' shapes, and xDeepFM's ``serve_p99`` step end to end; each
  output is checked against its plain version (bit for bit, NaN where NaN,
  for the lookups; float32 within 1e-5 absolute / bf16 within 2^-7 of the
  value + 1e-5 for the attention, 2 gamma_(m Hk + 2) of the sum of |terms|
  for the CIN).
* attention: ``flash_attention_tpu`` at the two LM prefill layers
  (qwen3-8b and moonshot-v1-16b-a3b, 4 x 2,048 tokens, hd 128, bf16: the
  ``wgmma`` instance), called as serving calls it (no log-sum-exp), beside
  its plain version within the bf16 limit.

Prints one JSON line: the card's name and power limit, the checkout's
``src``, the timing's own floor (two events back to back, an almost empty
kernel between them), and per shape the median device time of ``--reps``
CUDA-event timings (the card kept busy while the call is queued) and, for
the serve step, host seconds per call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def device_ms(torch, fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up, the
    card kept busy while each call is queued (so the events bracket device
    time alone)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def window_split(torch, step, arrays: dict, qt, ql, row_start: int = 0, reps: int = 20,
                 traced: int = 5) -> dict:
    """Where one window of a serve step goes, on a card: ``host_ms``, the
    step call itself (its Python side: the wrappers' checks and the
    launches; the card does not make it wait); ``window_ms``, the step and
    its outputs' copies to the host, as the server's window loop runs it
    (medians of ``reps`` after a warm-up); then ``traced`` windows under
    ``torch.profiler`` (device activity only): device ms, kernels and
    copies a window, and kernels and their device ms a window by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = arrays["anchors"].device
    qt_d, ql_d = torch.from_numpy(qt).to(dev), torch.from_numpy(ql).to(dev)

    def window():
        return tuple(o.cpu() for o in step(arrays, qt_d, ql_d, row_start))

    host, wall = [], []
    with torch.no_grad():
        for _ in range(3):
            window()
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(arrays, qt_d, ql_d, row_start)
            t1 = time.perf_counter()
            answer = tuple(o.cpu() for o in out)
            wall.append(time.perf_counter() - t0)
            host.append(t1 - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                window()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    return {"host_ms": statistics.median(host) * 1e3,
            "window_ms": statistics.median(wall) * 1e3,
            "device_ms": sum(e.self_device_time_total for e in events) / traced / 1e3,
            "kernels_per_window": sum(e.count for e in kernels) / traced,
            "copies_per_window": sum(e.count for e in copies) / traced,
            "kernels_by_name": {e.key[:80]: e.count / traced for e in kernels},
            "device_ms_by_name": {e.key[:80]: e.self_device_time_total / traced / 1e3
                                  for e in kernels},
            "answer": {"candidates": int(answer[0].numel()),
                       "matches": int(answer[1].sum().item()),
                       "digest": int((answer[0].long() * answer[1]).sum().item())}}


#: the fused server's arrays a windows file holds for each batch
FUSED_ARRAYS = ("anchors", "c_offsets", "c_ptr", "c_len", "pool", "lengths")
#: the arguments of a signature call a windows file holds, under
#: ``mining/documents/`` and ``rlz/posting-lists/``
SIGNATURE_ARGS = ("shingles", "lens", "a", "b")


def digest(torch, x) -> int:
    """A sum of the output's bits, equal across checkouts that agree."""
    bits = x.view(torch.int32) if x.dtype == torch.float32 else x
    return int(bits.long().sum().item())


def signature_calls(torch, out: dict, reps: int, path: str) -> None:
    import numpy as np

    from repro_torch.kernels.minhash_sig import ops as mh

    data = np.load(path)
    for at in ("mining/documents", "rlz/posting-lists"):
        args = [torch.from_numpy(data[f"{at}/{k}"]).cuda() for k in SIGNATURE_ARGS]
        got = mh.minhash_rows(*args)
        no_lanes = [args[0], torch.zeros_like(args[1]), *args[2:]]
        row = {"ms": device_ms(torch, lambda: mh.minhash_rows(*args), reps),
               "ms_no_live_lanes": device_ms(torch, lambda: mh.minhash_rows(*no_lanes), reps),
               "equal": bool(torch.equal(got, mh.minhash_rows_torch(*args))),
               "digest": digest(torch, got), "shape": list(args[0].shape)}
        if hasattr(mh, "minhash_rows_route"):
            row["route"] = mh.minhash_rows_route(args[0])
        out[f"minhash_rows/{at}"] = row


def fused_steps(torch, out: dict, reps: int, path: str) -> None:
    import numpy as np

    from repro_torch.serving.engine import make_serve_step

    data = np.load(path)
    for batch in ("phrase2", "and2"):
        arrays = {k: torch.from_numpy(data[f"{batch}/{k}"]).cuda() for k in FUSED_ARRAYS}
        qt, ql = data[f"{batch}/qt"], data[f"{batch}/ql"]
        step = make_serve_step(max_terms=qt.shape[1], mode=batch.rstrip("0123456789"),
                               probe="kernel", layout="fused",
                               max_phrase=int(data[f"{batch}/max_phrase"]))
        out[f"fused step/{batch}, B {qt.shape[0]}, W {qt.shape[1]}, first window"] = \
            window_split(torch, step, arrays, qt, ql, reps=reps)


#: the positional index's d-gap stream on the serving path: the whole stream,
#: its longest list, and a list of 4,096 values
DGAP_SHAPES = (("whole stream", 1_603_481), ("longest list", 196_811),
               ("4,096-value list", 4_096))


def index_side(torch, out: dict, reps: int, seed: int, dev=None) -> None:
    import numpy as np

    from repro_torch.kernels.dgap_decode import ops as dg

    dev = dev or torch.device("cuda")
    rng = np.random.default_rng(seed)
    redesigned = hasattr(dg, "dgap_decode_route")
    for name, n in DGAP_SHAPES:
        buf = torch.from_numpy(rng.integers(1, 1 << 12, n + 1).astype(np.int32)).to(dev)
        x = buf[:n]
        want = dg.dgap_decode_torch(x)
        row = {"ms": device_ms(torch, lambda: dg.dgap_decode(x), reps),
               "equal": bool(torch.equal(dg.dgap_decode(x), want)),
               "library_ms": device_ms(torch, lambda: torch.cumsum(x, 0, dtype=torch.int32),
                                       reps)}
        if redesigned:  # the element-load route, on a view one element in
            row["ms_scalar"] = device_ms(torch, lambda: dg.dgap_decode(buf[1:]), reps)
            row["equal"] &= bool(torch.equal(dg.dgap_decode(buf[1:]),
                                             dg.dgap_decode_torch(buf[1:])))
        out[f"dgap_decode/{name}, n {n}"] = row


def lookups(torch, out: dict, reps: int, seed: int) -> None:
    """``embedding_bag`` at xDeepFM's serve_bulk calls: the x0 lookup (one
    id a bag into the (3,008,562, 10) float32 table) and the linear term
    (bags of the 39 fields' ids into ``linear[:, None]``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import recsys_batches
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models import steps

    dev = torch.device("cuda")
    cfg = get_config("xdeepfm")
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rows = cfg.shapes["serve_bulk"].dims["batch"]
    fields = next(recsys_batches(cfg, rows, seed=seed))["fields"]
    offsets = np.concatenate([[0], np.cumsum(cfg.field_vocab_sizes)[:-1]])
    ids = torch.from_numpy((fields + offsets).astype(np.int32)).to(dev)
    with torch.no_grad():
        for name, args in (("x0 lookup", (ids.reshape(-1), params.table, 1)),
                           ("linear term", (ids, params.linear[:, None], cfg.n_fields))):
            got, want = eb.embedding_bag(*args), eb.embedding_bag_torch(*args)
            row = {"ms": device_ms(torch, lambda: eb.embedding_bag(*args), reps),
                   "equal": bool(torch.equal(got.nan_to_num(), want.nan_to_num())
                                 and torch.equal(got.isnan(), want.isnan())),
                   "digest": digest(torch, got)}
            if hasattr(eb, "embedding_bag_route"):
                row["route"] = eb.embedding_bag_route(args[1])
            out[f"embedding_bag/serve_bulk {name}, {args[0].numel()} ids"] = row
    del params


def model_side(torch, out: dict, reps_arg: int, seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import recsys_batches
    from repro_torch.kernels.cin_interaction.ops import cin_layer, cin_layer_torch
    from repro_torch.kernels.flash_decode.ops import flash_decode, flash_decode_torch
    from repro_torch.models import steps

    dev = torch.device("cuda")
    lookups(torch, out, reps_arg, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, h, kh in (("qwen3-8b", 32, 8), ("moonshot-v1-16b-a3b", 16, 16)):
        cache = torch.randn((2, 2, 4, 2080, kh, 128), generator=g, device=dev).bfloat16()
        q = torch.randn((4, 1, h, 128), generator=g, device=dev).bfloat16()
        kc, vc = cache[0, 0], cache[0, 1]
        pos = torch.full((4,), 2079, dtype=torch.int32, device=dev)
        got, want = flash_decode(q, kc, vc, pos).float(), flash_decode_torch(q, kc, vc, pos).float()
        ok = bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())
        out[f"flash_decode/{name} decode, B 4, S 2080"] = {
            "ms": device_ms(torch, lambda: flash_decode(q, kc, vc, pos), reps_arg), "within": ok}
        del cache
    u = 2.0 ** -24
    for rows in (512, 262144):
        for hk in (39, 200):
            x0 = torch.randn((rows, 39, 10), generator=g, device=dev)
            xk = torch.randn((rows, hk, 10), generator=g, device=dev)
            w = torch.randn((39 * hk, 200), generator=g, device=dev) * 0.05
            n = 39 * hk + 2
            limit = 2 * n * u / (1 - n * u) * cin_layer_torch(x0.abs(), xk.abs(), w.abs())
            ok = bool(((cin_layer(x0, xk, w) - cin_layer_torch(x0, xk, w)).abs() <= limit).all())
            reps = reps_arg if rows < 10_000 else 3
            out[f"cin_layer/B {rows}, Hk {hk}"] = {
                "ms": device_ms(torch, lambda: cin_layer(x0, xk, w), reps), "within": ok}
            del x0, xk, w, limit
    cfg = get_config("xdeepfm")
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    fields = torch.from_numpy(next(recsys_batches(cfg, 512, seed=seed))["fields"]).to(dev)
    serve = steps.make_recsys_serve_step(cfg)
    for _ in range(3):
        serve(params, fields=fields)
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps_arg):
        t0 = time.perf_counter()
        serve(params, fields=fields)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["xdeepfm serve_p99 step (512 rows), s"] = statistics.median(secs)


def attention(torch, out: dict, reps: int, seed: int) -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention_torch, flash_attention_tpu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, h, kh in (("qwen3-8b", 32, 8), ("moonshot-v1-16b-a3b", 16, 16)):
        q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
                   for s in ((4, 2048, h, 128), (4, 2048, kh, 128), (4, 2048, kh, 128)))
        got = flash_attention_tpu(q, k, v, True).float()
        want = flash_attention_torch(q, k, v, True).float()
        ok = bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())
        out[f"flash_attention_tpu/{name} prefill layer, B 4, T 2048"] = {
            "ms": device_ms(torch, lambda: flash_attention_tpu(q, k, v, True), reps),
            "within": ok}
        del q, k, v, got, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("index", "model", "attention"), default=None,
                    help="time one side only, or the prefill attention alone (default: "
                         "both sides)")
    ap.add_argument("--windows", default=None,
                    help="recorded fused windows (chip_smoke.py --save-windows) to time "
                         "one serve step on (index side)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("ab_timing.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {"src": str(Path(args.src).resolve()),
                 "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True).stdout.strip()}
    # what any timed call costs here: two events back to back, and an
    # (almost) empty kernel between them
    out["timing floor"] = {"events_ms": device_ms(torch, lambda: None, args.reps),
                           "empty_kernel_ms": device_ms(torch, lambda: torch.cuda._sleep(0),
                                                        args.reps)}
    if args.only == "attention":
        attention(torch, out, args.reps, args.seed)
    if args.only in (None, "index"):
        index_side(torch, out, args.reps, args.seed)
        if args.windows:
            fused_steps(torch, out, args.reps, args.windows)
            signature_calls(torch, out, args.reps, args.windows)
    if args.only in (None, "model"):
        model_side(torch, out, args.reps, args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
