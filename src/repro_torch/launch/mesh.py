"""The 1-D ``('shard',)`` mesh of the sharded embedding store
(``runtime.sharded_engine``).

One process drives every shard: shard k's store, cache and step live on
``devices[k]``, and the engine moves the shards' partial results to the
first shard's device to combine them. No process group is involved, so the
same code runs with one card per shard, with every shard on one card (given
as an explicit device list), and with every shard on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class EmbedMesh:
    """The devices of the shards, shard k on ``devices[k]``."""
    devices: Tuple[torch.device, ...]

    axis_names = ("shard",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"shard": len(self.devices)}


def make_embed_mesh(num_shards: int = 0, device="cuda", *,
                    devices: Optional[Sequence] = None) -> EmbedMesh:
    """A mesh of ``num_shards`` shards. On ``cuda`` shard k goes on card k
    and 0 means every card; more shards than cards raises ``ValueError``
    (nothing wraps shards onto fewer cards). ``device="cpu"`` puts every
    shard on the CPU (0 means one shard). An explicit ``devices`` list wins
    over ``device``: shard k goes on ``devices[k]``, so several shards may
    share one card; ``num_shards`` then takes a prefix of it (0: all)."""
    if num_shards < 0:
        raise ValueError(f"num_shards must be >= 0, got {num_shards}")
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        n = num_shards or len(devs)
        if not devs or n > len(devs):
            raise ValueError(f"requested {n} shards, only {len(devs)} devices")
        return EmbedMesh(devs[:n])
    dev = resolve_device(device)
    if dev.type == "cpu":
        return EmbedMesh((dev,) * (num_shards or 1))
    if dev.type != "cuda":
        raise ValueError(f"shards go on cuda or cpu devices, got {dev}")
    count = torch.cuda.device_count()
    n = num_shards or count
    if n > count:
        raise ValueError(f"requested {n} shards, only {count} devices; pass "
                         "devices=[...] to put several shards on one card")
    return EmbedMesh(tuple(torch.device("cuda", k) for k in range(n)))
