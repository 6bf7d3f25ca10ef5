"""End-to-end driver: train a 75.5M-parameter LM for a few hundred steps on the
synthetic repetitive corpus, with async checkpointing + auto-resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

(The model is a scaled-down granite-3-2b family member: 8 layers, d=512,
the full vocab, float32.  On ``--device cuda``, the
default, attention runs the flash kernel's forward and lse under autograd;
``cpu`` only when the caller asks.  On a mesh, see
``repro_torch.sharding.spmd``.)
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs import get_config
from ..core.device import resolve_device
from ..data.pipelines import lm_batches
from ..models import steps as steps_mod
from ..train.loop import TrainLoop
from ..train.optimizer import OptConfig


def lm_config():
    return dataclasses.replace(
        get_config("granite-3-2b"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=49155, dtype="float32",
    )


def main(argv=None, state=None) -> dict:
    """``state`` (a train state on the device, e.g. a reference state
    carried across with ``steps.train_state_from_reference``) replaces the
    seeded one; returns the per-step logs, the step it started from and the
    checkpointed steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_config()
    print(f"model: {cfg.n_params()/1e6:.1f}M params")

    opt = OptConfig(kind="adamw", lr=3e-4, warmup_steps=30, total_steps=args.steps)
    if state is None:
        params = steps_mod.init_model_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        state = steps_mod.init_state(params, opt)
    step = steps_mod.make_lm_train_step(cfg, opt)
    data = lm_batches(cfg, args.batch, args.seq, seed=0)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    ck = Checkpointer(ckpt_dir, keep=2)
    state, start = TrainLoop.resume_or_init(ck, state)
    loop = TrainLoop(train_step=step, data_iter=data, checkpointer=ck,
                     ckpt_every=args.ckpt_every)
    state, logs = loop.run(state, args.steps, start_step=start)

    losses = [l["loss"] for l in logs]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(logs)} steps "
          f"(mean step {np.mean([l['dt_s'] for l in logs]) * 1e3:.0f} ms, "
          f"stragglers {sum(l['straggler'] for l in logs)})")
    print(f"checkpoints in {ckpt_dir}: steps {ck.all_steps()}")
    return {"logs": logs, "start": start, "ckpt_steps": ck.all_steps(), "state": state}


if __name__ == "__main__":
    main()
