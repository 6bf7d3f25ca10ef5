"""End-to-end training driver (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --reduced --device cpu

Runs the train loop (data pipeline -> train step -> async checkpoints ->
auto-resume) on ``--device`` (``cuda`` unless the caller asks for ``cpu``;
on a machine without a card ``cuda`` raises).  On CUDA the steps launch the
hand-written kernels of their models (attention and ``moe_gemm`` for the
LMs, ``embedding_bag`` and ``cin_layer`` for the recsys models); on the CPU
the same steps run the plain versions.  ``--reduced`` swaps in the
smoke-scale config of the same family.  Weights are drawn with a
``torch.Generator`` on the device seeded by ``--seed``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs import get_config
from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..core.device import resolve_device
from ..data import graphs as graph_data
from ..data.pipelines import lm_batches, recsys_batches
from ..models import gnn as gnn_mod
from ..models import steps as steps_mod
from ..train.loop import TrainLoop
from ..train.optimizer import OptConfig


def build_training(cfg, batch: int, seq: int, seed: int = 0, device="cuda"):
    """``(state, train_step, data iterator)`` of ``cfg``, as the reference
    builds them (AdamW, warmup 20 steps; the GNN on a 2,000-node synthetic
    graph, fanout (10, 5))."""
    dev = resolve_device(device)
    opt = OptConfig(kind="adamw", warmup_steps=20, total_steps=100000)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(cfg, LMConfig):
        params = steps_mod.init_model_params(cfg, gen, dev)
        step = steps_mod.make_lm_train_step(cfg, opt)
        data = lm_batches(cfg, batch, seq, seed)
    elif isinstance(cfg, GNNConfig):
        g = graph_data.synthetic_graph(2000, 8, 32, 5, seed)
        params = gnn_mod.init_params(cfg, gen, 32, 5, dev)
        step = steps_mod.make_gnn_train_step(cfg, opt)
        data = graph_data.graph_batches(g, batch, (10, 5), seed)
    elif isinstance(cfg, RecsysConfig):
        params = steps_mod.init_model_params(cfg, gen, dev)
        step = steps_mod.make_recsys_train_step(cfg, opt)
        data = recsys_batches(cfg, batch, seed)
    else:
        raise TypeError(type(cfg))
    return steps_mod.init_state(params, opt), step, data


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse ``argv`` (the process's arguments when ``None``), train, print
    a summary line and return the steps' log records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    state, step, data = build_training(cfg, args.batch, args.seq, args.seed, args.device)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    state, start = TrainLoop.resume_or_init(ckpt, state)
    if start:
        print(f"resumed from step {start}")
    loop = TrainLoop(train_step=step, data_iter=data, checkpointer=ckpt,
                     ckpt_every=args.ckpt_every, log_path=args.log)
    state, logs = loop.run(state, args.steps, start_step=start)
    last = logs[-1] if logs else {}
    print(f"steps {start}..{start + args.steps}: "
          f"loss {logs[0].get('loss', float('nan')) if logs else float('nan'):.4f} -> "
          f"{last.get('loss', float('nan')):.4f}  "
          f"mean dt {np.mean([l['dt_s'] for l in logs]) if logs else float('nan'):.3f}s  "
          f"stragglers {sum(l['straggler'] for l in logs)}")
    return logs


if __name__ == "__main__":
    main()
