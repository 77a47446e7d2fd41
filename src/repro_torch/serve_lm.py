"""Decode seeded token streams through an LM of the dense, MoE, SSM or
hybrid family: the port's LM serving path end to end.

``decode`` feeds each sequence's tokens one position at a time through
``decode_step``, as the reference's decode step
(``src/repro/launch/steps.py``) is driven in a loop: a KV cache per
attention layer (a window-sized ring for a sliding-window config), an SSD
state per SSM layer, a KV cache per call of the hybrid's shared block;
full-attention decode goes through the ``flash_decode`` CUDA kernel on the
card. Weights are random from a seeded generator; tokens are seeded too.
There is no prefill-to-cache path: the reference has none either.

Run: PYTHONPATH=src python -m repro_torch.serve_lm \
         [--arch smollm-135m --batch 8 --tokens 256 --max-len 1024 --device cuda]
     (``--device cpu --reduced`` for a small CPU run)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import DECODE_ARCHS, ModelConfig, get_config
from repro_torch.kernels import ops
from repro_torch.models.transformer import LM, decode_step, init_cache


def build(cfg: ModelConfig, *, seed: int = 0, torch_device="cuda") -> LM:
    """The model, weights from a generator seeded with ``seed``."""
    return LM(cfg, device=torch_device, generator=torch.Generator().manual_seed(seed))


def make_tokens(cfg: ModelConfig, *, batch: int, tokens: int, seed: int) -> np.ndarray:
    """[batch, tokens] int32 uniform over the vocabulary."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, tokens)).astype(np.int32)


def decode(model: LM, cache, tokens: torch.Tensor) -> torch.Tensor:
    """Feed tokens [B, T] at positions 0..T-1 through ``decode_step`` one at
    a time. Returns logits [B, T, V] on the model's device."""
    B, T = tokens.shape
    out = torch.empty((B, T, model.cfg.vocab_size), dtype=model.embed.dtype,
                      device=model.embed.device)
    for t in range(T):
        logits, cache = decode_step(model, cache, tokens[:, t:t + 1], t)
        out[:, t] = logits[:, 0]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=DECODE_ARCHS)
    ap.add_argument("--batch", type=int, default=8, help="sequences decoded together")
    ap.add_argument("--tokens", type=int, default=256, help="positions decoded")
    ap.add_argument("--max-len", type=int, default=1024,
                    help="KV cache length (capped at a sliding window)")
    ap.add_argument("--device", default="cuda", help="torch device")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config")
    args = ap.parse_args(argv)
    if args.tokens > args.max_len:
        ap.error(f"--tokens {args.tokens} exceeds --max-len {args.max_len}")

    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    model = build(cfg, seed=0, torch_device=args.device)
    device = model.embed.device
    tokens = torch.from_numpy(make_tokens(cfg, batch=args.batch, tokens=args.tokens,
                                          seed=1)).to(device)
    cache = init_cache(cfg, args.batch, args.max_len, device=device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = decode(model, cache, tokens)
    top1 = logits.argmax(dim=-1).cpu()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    print(f"decoded {args.tokens} positions x {args.batch} sequences of {cfg.name} "
          f"({cfg.family}) on {device} (bf16 cache, KV of {args.max_len})")
    print(f"  logits {tuple(logits.shape)}, finite: {finite}, "
          f"first top-1 tokens {top1[0, :8].tolist()}")
    print(f"  wall per step: {wall / max(1, args.tokens) * 1e3:.2f} ms (host clock)")
    print(f"  flash_decode launches: {ops.launch_counts()['flash_decode']}")


if __name__ == "__main__":
    main()
