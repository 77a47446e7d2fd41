"""Atomic checkpointing with restart and re-placement.

The port of ``repro.checkpoint.manager``, with its on-disk layout:
``<dir>/step_<N>/`` holds one ``.npy`` per tree leaf, named by the leaf's
key path (``params/bottom/0/w`` -> ``params__bottom__0__w.npy``), and a
``manifest.json`` (step; each leaf's file, shape and dtype). Trees carry the
reference's key paths and layouts (a DLRM ``w`` is ``[in, out]``, an LM
block leaf ``[L, ...]``), so either package restores the other's
checkpoint. Commit is atomic: written to ``step_<N>.tmp`` then renamed, so
a crash mid-save never corrupts the latest checkpoint; restore picks the
newest complete manifest.

Supports the paper's model-update path (App. A.3): *incremental embedding
updates* write only the changed embedding tables plus a delta manifest, so
frequent model refreshes do not rewrite the dense parameters.

``restore`` places each leaf on the device of the matching ``like`` leaf,
or on the device a matching tree of ``torch.device`` names (the reference's
``shardings``), which also serves a restart onto other devices.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten, key_of, unflatten


def _flatten(tree) -> Dict[str, Any]:
    paths, leaves = flatten(tree)
    return {key_of(p): leaf for p, leaf in zip(paths, leaves)}


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, order="C")


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") and \
                (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, state, step: int) -> str:
        flat = _flatten(state)
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for key, leaf in flat.items():
            arr = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)  # atomic commit
        self._gc()
        return str(final)

    def _gc(self):
        steps = sorted(s for s in (
            int(p.name.split("_")[1]) for p in self.dir.iterdir()
            if p.name.startswith("step_") and not p.name.endswith(".tmp")))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def restore(self, like, step: Optional[int] = None, *, devices=None):
        """Restore into the structure of ``like`` (a tree of tensors or
        arrays). Each leaf goes to the device of the matching leaf of
        ``devices`` (a matching tree of ``torch.device``s, or None), else to
        the device of the ``like`` tensor, else to the CPU. A leaf whose
        stored shape differs from ``like``'s raises."""
        step = step if step is not None else latest_step(str(self.dir))
        if step is None:
            return None, None
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = _flatten(like)
        flat_dev = _flatten(devices) if devices is not None else {}
        out = []
        for key, leaf in flat_like.items():
            info = manifest["leaves"][key]
            arr = np.load(d / info["file"])
            if hasattr(leaf, "shape") and tuple(leaf.shape) != arr.shape:
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            dev = flat_dev.get(key)
            if dev is None:
                dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(arr).to(dev))
        return unflatten(like, out), step


def incremental_embedding_update(base_dir: str, step: int, tables: Dict[str, Any],
                                 *, update_id: int) -> str:
    """Paper A.3: write only changed embedding tables (tensors or arrays) as
    a delta on top of a full checkpoint; serving hosts apply deltas
    cache-first with dirty write-back to SM."""
    d = Path(base_dir) / f"step_{step}" / f"emb_update_{update_id}.tmp"
    final = Path(str(d)[:-4])
    d.mkdir(parents=True, exist_ok=True)
    manifest = {"update_id": update_id, "tables": {}}
    for name, arr in tables.items():
        arr = _to_numpy(arr)
        np.save(d / f"{name}.npy", arr)
        manifest["tables"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    (d / "delta.json").write_text(json.dumps(manifest))
    os.replace(d, final)
    return str(final)
