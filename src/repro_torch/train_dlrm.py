"""End-to-end example: train a ~100M-parameter DLRM for a few hundred steps.

The port of the reference's ``examples/train_dlrm.py``, with the same arch
and the same printed lines: a synthetic Zipf CTR stream, AdamW with a
cosine schedule, the fault-tolerant trainer (checkpoints under ``--ckpt``,
resume on rerun). About 96.3M parameters, almost all of them embedding
rows, as in the paper's serving models. The tables' gradients are dense,
as the reference's, so AdamW updates every row every step.

Run: PYTHONPATH=src python -m repro_torch.train_dlrm \
         [--steps 300 --batch 256 --ckpt DIR --device cuda]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.data import dlrm_batch_stream
from repro_torch.models import dlrm
from repro_torch.optim import AdamW, TrainState, cosine_schedule, make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCH = dlrm.DLRMArch(
    num_dense=13, embed_dim=64,
    user_tables=(200_000,) * 6, item_tables=(100_000,) * 3,
    pooling=8, bottom_mlp=(512, 256, 64), top_mlp=(512, 256, 1))


def build(arch: dlrm.DLRMArch, *, steps: int, batch: int, ckpt_dir: str,
          device="cuda", ckpt_every: int = 100, **trainer_kw) -> Trainer:
    """The example's trainer: ``arch``'s weights from a generator seeded with
    0, AdamW with ``cosine_schedule(2e-3, warmup=50, total=steps)`` and
    weight decay 1e-5, batches of ``batch`` from seed 0. ``trainer_kw`` go
    to ``Trainer`` (the failure and straggler hooks)."""
    dev = resolve_device(device)
    params = dlrm.init_params(arch, device=dev,
                              generator=torch.Generator().manual_seed(0))
    opt = AdamW(lr=cosine_schedule(2e-3, warmup=50, total=steps), weight_decay=1e-5)
    step = make_train_step(lambda p, b: dlrm.loss_fn(p, b, arch), opt)
    return Trainer(step, TrainState(params, opt),
                   lambda s0: dlrm_batch_stream(arch, batch, seed=0, start_step=s0),
                   TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=ckpt_dir), **trainer_kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_dlrm_e2e"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = ARCH
    print(f"DLRM params: {arch.param_count()/1e6:.1f}M "
          f"({arch.num_tables} tables x dim {arch.embed_dim})")
    trainer = build(arch, steps=args.steps, batch=args.batch, ckpt_dir=args.ckpt,
                    device=args.device)
    start = trainer.try_restore()
    if start:
        print(f"resuming from checkpoint at step {start}")
    out = trainer.run()
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"loss: first10={sum(losses[:k])/k:.4f} "
              f"last10={sum(losses[-k:])/k:.4f} "
              f"steps={out['final_step']} stragglers={len(out['stragglers'])}")


if __name__ == "__main__":
    main()
