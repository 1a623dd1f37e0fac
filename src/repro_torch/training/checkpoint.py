"""Tree checkpointing: an npz of the leaves and a JSON of their key paths
(counterpart of ``repro/training/checkpoint.py``; the tree is flattened
by ``repro_torch.tree``)."""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten(tree)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, (_, x) in enumerate(flat)}
    np.savez(path + ".npz", **arrays)
    with open(path + ".tree.json", "w") as f:
        json.dump({"paths": [k for k, _ in flat], "n": len(flat)}, f)


def restore(path: str, like) -> Any:
    """Restore into the structure of ``like`` (key paths and shapes
    checked), each leaf with the dtype and on the device of ``like``'s
    leaf (the CPU for a leaf on the meta device)."""
    with open(path + ".tree.json") as f:
        meta = json.load(f)
    flat = flatten(like)
    if meta["paths"] != [k for k, _ in flat]:
        raise ValueError(f"{path}: the checkpoint's tree differs from the "
                         f"one to restore into")
    out = []
    with np.load(path + ".npz") as data:
        for i, (key, ref) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"wants {tuple(ref.shape)}")
            dev = "cpu" if ref.is_meta else ref.device
            out.append(torch.as_tensor(arr).to(dev, ref.dtype))
    return unflatten(like, out)


def exists(path: str) -> bool:
    return os.path.exists(path + ".npz")
