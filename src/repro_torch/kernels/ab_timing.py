"""Time ``flash_decode`` and ``cin_layer`` at the LM and recsys serving paths'
shapes, and xDeepFM's ``serve_p99`` step end to end, on one CUDA card, for
the ``repro_torch`` found first on ``sys.path``::

    python3 src/repro_torch/kernels/ab_timing.py [--src OTHER/src] [--reps N]

``--src`` puts another checkout's ``src`` first, so two checkouts of the
port (say a commit and its parent) are timed by the same code on the same
card: run them in turns in one call (A B B A).  Inputs are random, seeded;
each kernel's output is checked against its plain version (float32 within
1e-5 absolute / bf16 within 2^-7 of the value + 1e-5 for the attention,
2 gamma_(m Hk + 2) of the sum of |terms| for the CIN).  Prints one JSON
line: the card's name and power limit, the checkout's ``src``, and per shape
the median device time of ``--reps`` CUDA-event timings (the card kept busy
while the call is queued) and, for the serve step, host seconds per call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("ab_timing.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import recsys_batches
    from repro_torch.kernels.cin_interaction.ops import cin_layer, cin_layer_torch
    from repro_torch.kernels.flash_decode.ops import flash_decode, flash_decode_torch
    from repro_torch.models import steps

    def device_ms(fn, reps: int) -> float:
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

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out: dict = {"src": str(Path(args.src).resolve()),
                 "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True).stdout.strip()}
    for name, h, kh in (("qwen3-8b", 32, 8), ("moonshot-v1-16b-a3b", 16, 16)):
        cache = torch.randn((2, 2, 4, 2080, kh, 128), generator=g, device=dev).bfloat16()
        q = torch.randn((4, 1, h, 128), generator=g, device=dev).bfloat16()
        kc, vc = cache[0, 0], cache[0, 1]
        pos = torch.full((4,), 2079, dtype=torch.int32, device=dev)
        got, want = flash_decode(q, kc, vc, pos).float(), flash_decode_torch(q, kc, vc, pos).float()
        ok = bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())
        out[f"flash_decode/{name} decode, B 4, S 2080"] = {
            "ms": device_ms(lambda: flash_decode(q, kc, vc, pos), args.reps), "within": ok}
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
            reps = args.reps if rows < 10_000 else 3
            out[f"cin_layer/B {rows}, Hk {hk}"] = {
                "ms": device_ms(lambda: cin_layer(x0, xk, w), reps), "within": ok}
            del x0, xk, w, limit
    cfg = get_config("xdeepfm")
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    fields = torch.from_numpy(next(recsys_batches(cfg, 512, seed=args.seed))["fields"]).to(dev)
    serve = steps.make_recsys_serve_step(cfg)
    for _ in range(3):
        serve(params, fields=fields)
    torch.cuda.synchronize()
    secs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        serve(params, fields=fields)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["xdeepfm serve_p99 step (512 rows), s"] = statistics.median(secs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
