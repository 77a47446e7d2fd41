"""Train an LM of the dense, MoE, SSM or hybrid family (reduced config
unless ``--full``) on synthetic tokens.

The port of the reference's ``examples/lm_train.py``, with the same printed
lines: AdamW 1e-3 over ``make_lm_batch`` batches (seed 0, step i). The VLM
and encoder archs raise ``NotImplementedError`` (ROADMAP item 6).

Run: PYTHONPATH=src python -m repro_torch.lm_train \
         [--arch smollm-135m --steps 30 --batch 8 --seq 64 --full --device cuda]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, get_config, list_archs
from repro_torch.data import make_lm_batch
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, TrainState, make_train_step
from repro_torch.tree import tree_map


def build(cfg: ModelConfig, *, device="cuda"):
    """(state, step_fn): ``cfg``'s weights from a generator seeded with 0,
    on ``device``; AdamW at 1e-3."""
    T.require_ported(cfg)
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev),
                      T.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = AdamW(lr=1e-3)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    return TrainState(params, opt), step


def lm_batch(cfg: ModelConfig, batch: int, seq: int, step: int, device) -> dict:
    raw = make_lm_batch(cfg.vocab_size, batch, seq, seed=0, step=step)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(list_archs()))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (default: reduced)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    print(f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"({cfg.param_count()/1e6:.1f}M params)")
    state, step = build(cfg, device=args.device)
    dev = state["step"].device
    for i in range(args.steps):
        state, m = step(state, lm_batch(cfg, args.batch, args.seq, i, dev))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss {float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
