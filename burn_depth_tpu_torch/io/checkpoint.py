"""Native checkpoint format: safetensors of ``/``-joined param-tree paths
(counterpart of ``burn_depth_tpu/io/checkpoint.py``).

A param tree is nested dicts and lists of tensors; ``None`` leaves (absent
biases, identity projections) are skipped, exactly as ``jax.tree_util``
skips them, so a file written by either package loads into the other.

The safetensors container is read and written here directly (an 8-byte
little-endian header length, a JSON header of dtype/shape/offsets, then the
raw tensor bytes) so the port does not depend on the ``safetensors``
package, which the machines that run it may not have.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Optional

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def flatten_tree(params: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Param tree → ``{path: tensor}`` with ``/``-joined keys."""
    out: dict[str, torch.Tensor] = {}
    if params is None:
        return out
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        out[prefix] = params
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def map_tree(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """Rebuild ``tree`` with every non-``None`` leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def as_tensor(a) -> torch.Tensor:
    """numpy array (including ml_dtypes bfloat16) or tensor → CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.array(a)  # a writable copy: read-only arrays cannot back a tensor
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native torch mapping
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def unflatten_into(template: Any, flat: dict, device) -> Any:
    """Fill a template tree from ``{path: array}``.

    Raises with the full lists of missing/unexpected keys, and on any shape
    mismatch.  Each tensor is cast to the template leaf's dtype and moved to
    ``device``.
    """
    want = flatten_tree(template)
    missing = [k for k in want if k not in flat]
    unexpected = sorted(set(flat) - set(want))
    if missing or unexpected:
        raise KeyError(
            f"checkpoint/template mismatch: {len(missing)} missing, "
            f"{len(unexpected)} unexpected\nmissing: {missing[:20]}\nunexpected: {unexpected[:20]}"
        )

    def fill(path, leaf):
        t = as_tensor(flat[path])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != template {tuple(leaf.shape)}")
        return t.to(device=device, dtype=leaf.dtype).contiguous()

    return map_tree(fill, template)


def save_safetensors(path: str, flat: dict[str, torch.Tensor]) -> None:
    """Write ``{key: tensor}`` as one safetensors file."""
    header: dict = {}
    blobs = []
    offset = 0
    for key in sorted(flat):
        t = flat[key].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"{key}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[key] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read any ``.safetensors`` file to ``{key: CPU tensor}``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} exceeds the file size {len(data)}")
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{key}: unsupported safetensors dtype {meta['dtype']}")
        dtype = _DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        if not 0 <= begin <= end <= len(body):
            raise ValueError(f"{key}: data offsets {begin}:{end} outside the file body")
        raw = bytearray(body[begin:end])
        t = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype)
        # legacy native files spelled NamedTuple fields with a leading '.'
        out[key.replace("/.", "/").lstrip(".")] = t.reshape(meta["shape"])
    return out


def save_checkpoint(path: str, params: Any, *, storage_dtype: Optional[torch.dtype] = None) -> None:
    """Save a param tree.  ``storage_dtype`` (e.g. ``torch.float16``)
    down-casts floating leaves; None keeps the in-memory dtypes."""
    flat = flatten_tree(params)
    if storage_dtype is not None:
        flat = {k: v.to(storage_dtype) if v.is_floating_point() else v for k, v in flat.items()}
    save_safetensors(path, flat)


def load_checkpoint(path: str, template: Any, device) -> Any:
    """Load a native safetensors checkpoint into the structure and dtypes of
    ``template`` on ``device`` (strict: see :func:`unflatten_into`)."""
    return unflatten_into(template, load_safetensors(path), device)


def is_native_checkpoint(path: str) -> bool:
    """Native checkpoints use ``/``-joined keys; upstream PyTorch files use
    dotted keys.  Reads only the header."""
    if not os.fspath(path).endswith(".safetensors"):
        return False
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return any("/" in k for k in header if k != "__metadata__")
