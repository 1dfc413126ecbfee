"""Checkpointing: nested dicts of tensors <-> .npz with path-encoded keys
+ JSON metadata.

Counterpart of ``repro/checkpoint/checkpoint.py``, writing and reading
the same files, so a checkpoint written by one package loads in the
other:

* each leaf is stored under its path of dict keys joined with ``/``
  (``params/conv1/w``); keys are visited in sorted order, as JAX
  flattens a dict;
* numpy cannot hold bfloat16, so a bf16 leaf is stored as its uint16
  bit pattern and named in a ``__dtypes__`` record (a JSON object as
  uint8 bytes);
* a write is atomic: the npz goes to ``<path>.npz.tmp`` and is moved
  into place with ``os.replace``, so a crash mid-write leaves the
  previous complete checkpoint or none, never a truncated one; the
  metadata goes to ``<path>.meta.json`` the same way.

A tree is a dict whose values are dicts or leaves: tensors (any device;
copied to the host; a DTensor's full value), numpy arrays or scalars.
``load_pytree`` returns CPU tensors.  ``restore_sharded`` loads each
leaf as a DTensor with the mesh and placements of its target in an
abstract tree, so a checkpoint written on one mesh (or by the
reference) loads onto another (resharding on load).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

SEP = "/"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{'/'-joined key path: leaf}, dict keys in sorted order."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out.update(_flatten(tree[key], path + SEP))
        else:
            out[path] = tree[key]
    return out


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):  # a DTensor: its whole value
            leaf = leaf.full_tensor()
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Dict[str, Any],
                metadata: Optional[dict] = None) -> None:
    """Write ``tree`` to ``path``(.npz) atomically, and ``metadata`` (if
    given) to ``path.meta.json``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    dtypes = {}
    store = {}
    for key, leaf in _flatten(tree).items():
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
        store[key] = _to_numpy(leaf)
    store["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                        dtype=np.uint8)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **store)
    os.replace(tmp, final)
    if metadata is not None:
        tmp_meta = path + ".meta.json.tmp"
        with open(tmp_meta, "w") as f:
            json.dump(metadata, f, indent=2)
        os.replace(tmp_meta, path + ".meta.json")


def load_pytree(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """Load into the structure of ``like`` (its key paths must be in the
    file; its leaves only name them): nested dicts of CPU tensors."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        dtypes = {}
        if "__dtypes__" in data:
            dtypes = json.loads(bytes(data["__dtypes__"]).decode())
        leaves = {}
        for key in _flatten(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                leaves[key] = torch.from_numpy(
                    arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                leaves[key] = torch.from_numpy(np.array(arr))
    return _unflatten_like(like, leaves)


def _unflatten_like(like: Dict[str, Any], leaves: Dict[str, torch.Tensor],
                    prefix: str = "") -> Dict[str, Any]:
    return {key: (_unflatten_like(sub, leaves, f"{prefix}{key}{SEP}")
                  if isinstance(sub, dict) else leaves[f"{prefix}{key}"])
            for key, sub in like.items()}


def restore_sharded(path: str, abstract: Dict[str, Any]) -> Dict[str, Any]:
    """Load ``path`` into the structure of ``abstract`` and lay out each
    leaf as its target is: a target with a ``device_mesh`` and
    ``placements`` (a DTensor, or a ``launch.sharding.NamedSharding``)
    makes the leaf a DTensor on that mesh with those placements, moved
    to the mesh's device type; any other target leaves the CPU tensor
    as it is."""
    from torch.distributed.tensor import distribute_tensor
    host = load_pytree(path, abstract)

    def put(x, ref):
        if isinstance(ref, dict):
            return {k: put(x[k], ref[k]) for k in ref}
        mesh = getattr(ref, "device_mesh", None)
        if mesh is None:
            return x
        return distribute_tensor(x.to(mesh.device_type), mesh,
                                 ref.placements)

    return put(host, abstract)


def load_metadata(path: str) -> Optional[dict]:
    meta = path + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return None
