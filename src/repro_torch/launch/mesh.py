"""Meshes of the port, and the card's roofline constants.

* :func:`make_embed_mesh` -- the 1-D ``('shard',)`` mesh of the sharded
  embedding store (``runtime.sharded_engine``). One process drives every
  shard: shard k's store, cache and step live on ``devices[k]``, and the
  engine moves the shards' partial results to the first shard's device to
  combine them. No process group is involved, so the same code runs with
  one card per shard, with every shard on one card (given as an explicit
  device list), and with every shard on the CPU.
* :func:`make_production_mesh` -- the LM launch study's meshes, 16x16
  (``data``, ``model``) and 2x16x16 (``pod``, ``data``, ``model``), as
  ``DeviceMesh``es over a fake process group: a step traced on them runs
  on fake tensors and issues no collective (``launch.dryrun``).
* :func:`make_host_mesh` -- a (``data``, ``model``) ``DeviceMesh`` over the
  ranks of a real process group on the local cards (one rank, one card,
  when the process runs alone).

A process holds one default process group. The fake one is created once,
lazily, at the largest production mesh's 512 ranks; the 256-rank mesh and
:func:`make_mesh_compat`'s meshes take its first ranks (the reference
forces 512 host devices for the same reason). Importing this module touches
no device and no process-group state.
"""
from __future__ import annotations

import dataclasses
import math
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device

# Roofline constants of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
# rates), read beside "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi's
# name and power limit of the card they are used with).
PEAK_FLOPS_BF16 = 989e12      # tensor cores, bf16, per card
HBM_BW = 3.35e12              # bytes/s of device memory per card
# torch.cuda.get_device_properties(0).total_memory on that card
HBM_PER_CHIP = 85_017_493_504
# The collective term's one link rate (the reference's ICI_BW): both
# production meshes' 16-wide axes span two 8-card HGX H100 nodes, so their
# rings cross the network; a card's NVIDIA ConnectX-7 NDR InfiniBand port
# moves 400 Gb/s, 50e9 bytes/s each way.
LINK_BW = 50e9

WORLD = 512                   # ranks of the fake process group


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


def _is_fake_group() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_backend() == "fake"


def _fake_world(n: int) -> None:
    """The fake default process group, created at ``WORLD`` ranks if none
    exists; raises if a real group holds the process or ``n`` is larger."""
    import torch.distributed as dist
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    if not _is_fake_group():
        raise RuntimeError("a real process group holds this process; the "
                           "production meshes need the fake one")
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks exceeds the fake group's "
                         f"{dist.get_world_size()}")


def make_mesh_compat(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` names over the first
    ranks of the fake process group (the reference's name for its
    ``jax.make_mesh`` across JAX versions). ``device`` is the device type of
    the fake tensors placed on it; no card is needed."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    _fake_world(n)
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """A (``data``, ``model``) mesh over the ranks of the default process
    group on the local cards (``cuda`` unless the caller asks for
    ``cpu``). With no group yet, the process starts one of its own: one
    rank at ``tcp://localhost``, NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    if _is_fake_group():
        raise RuntimeError("the fake process group holds this process; the "
                           "host mesh needs a real one")
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // model_axis, model_axis),
                      mesh_dim_names=("data", "model"))
