"""Weight bundles: the model artifact shared with ``gliclass.c_tpu``.

A bundle is a directory:

    bundle/
      config.json               GLiClassConfig (+ original_model_name etc.)
      goldens.json              golden-logit records (fp32 torch reference)
      weights.safetensors       fp32 params, keys are /-joined tree paths
      weights_int8.safetensors  optional INT8 weights + scales (quant bundle)
      tokenizer.json            HF tokenizers file

The safetensors files are read by :func:`read_safetensors` and written by
:func:`write_safetensors`, a small numpy reader and writer of the format, so
neither loading nor writing a bundle needs the ``safetensors`` package. The
writer's bytes equal ``safetensors.numpy.save_file``'s (0.8) for the same
tensors.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch

from ..config import GLiClassConfig

Params = dict[str, Any]

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(dt): name for name, dt in _ST_DTYPES.items()}
# The writer's tensor order: safetensors' Dtype enum, last member first (so
# wider types come first), then the name.
_ST_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16", "I16", "I8", "U8", "BOOL")


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """safetensors file -> {name: array}; BF16 tensors are widened to fp32
    (exact), since numpy has no bfloat16.

    Layout: an unsigned 64-bit little-endian header length N, N bytes of JSON
    header ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus an
    optional "__metadata__"), then the raw little-endian tensor bytes, with
    offsets relative to the end of the header."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] == "BF16":
            bits = torch.from_numpy(np.frombuffer(data[begin:end], dtype="<u2").astype(np.int16))
            out[name] = bits.view(torch.bfloat16).float().numpy().reshape(info["shape"])
            continue
        dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        arr = np.frombuffer(data[begin:end], dtype=np.dtype(dt).newbyteorder("<"))
        out[name] = arr.astype(dt, copy=True).reshape(info["shape"])
    return out


def _st_leaf(v) -> tuple[str, np.ndarray]:
    """A numpy array or CPU tensor -> (safetensors dtype, little-endian
    C-contiguous array of its bytes); bfloat16 tensors as their uint16 bits."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            raise ValueError(f"write_safetensors takes CPU tensors, got one on {v.device}")
        v = v.detach()
        if v.dtype == torch.bfloat16:
            return "BF16", v.contiguous().view(torch.int16).numpy().view("<u2")
        v = v.numpy()
    a = np.asarray(v)
    name = _ST_NAMES.get(a.dtype.newbyteorder("="))
    if name is None:
        raise ValueError(f"write_safetensors: unsupported dtype {a.dtype}")
    return name, a.astype(a.dtype.newbyteorder("<"), order="C", copy=False)


def write_safetensors(tensors: dict, path: str) -> None:
    """{name: numpy array or CPU tensor} -> a safetensors file, byte-equal to
    ``safetensors.numpy.save_file`` without metadata: tensors ordered by
    dtype (:data:`_ST_ORDER`) then name, packed without gaps; the compact
    JSON header in that order, padded with spaces to a multiple of 8 bytes."""
    leaves = {k: _st_leaf(v) for k, v in tensors.items()}
    order = sorted(leaves, key=lambda k: (_ST_ORDER.index(leaves[k][0]), k))
    header, offset = {}, 0
    for k in order:
        dtype, a = leaves[k]
        header[k] = {"dtype": dtype, "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    head = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for k in order:
            f.write(leaves[k][1].tobytes())


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}; leaves stay as they are (numpy arrays
    or tensors)."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> Params:
    root: Params = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def _bundle_leaves(params: Params) -> dict[str, Any]:
    """The flat tree as the JAX package writes it (``np.ascontiguousarray``
    of each leaf): a 0-d leaf such as ``logit_scale`` is stored as [1]."""
    return {k: v.reshape(1) if v.ndim == 0 else v
            for k, v in flatten_tree(params).items()}


def save_bundle(
    path: str,
    cfg: GLiClassConfig,
    params: Params,
    tokenizer_json: str | None = None,
    goldens: list[dict] | None = None,
    int8_params: Params | None = None,
) -> None:
    """Write a bundle directory as the JAX package's ``save_bundle`` does:
    config.json, weights.safetensors, and where given
    weights_int8.safetensors, tokenizer.json and goldens.json. Leaves are
    numpy arrays or CPU tensors."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())
    write_safetensors(_bundle_leaves(params), os.path.join(path, "weights.safetensors"))
    if int8_params is not None:
        write_safetensors(_bundle_leaves(int8_params), os.path.join(path, "weights_int8.safetensors"))
    if tokenizer_json is not None:
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            f.write(tokenizer_json)
    if goldens is not None:
        with open(os.path.join(path, "goldens.json"), "w") as f:
            json.dump(goldens, f)


def load_config(path: str) -> GLiClassConfig:
    with open(os.path.join(path, "config.json")) as f:
        return GLiClassConfig.from_json(f.read())


def load_params(path: str, quantized: bool = False) -> Params:
    """Bundle weights as a nested dict of numpy arrays (per-layer leaves
    stacked on a leading [L, ...] axis); :func:`convert.params.params_from_numpy`
    moves them to torch."""
    name = "weights_int8.safetensors" if quantized else "weights.safetensors"
    fp = os.path.join(path, name)
    if not os.path.exists(fp):
        raise FileNotFoundError(
            f"{fp} not found"
            + (" — run the converter with --quantize first" if quantized else "")
        )
    return unflatten_tree(read_safetensors(fp))


def load_goldens(path: str) -> list[dict]:
    fp = os.path.join(path, "goldens.json")
    if not os.path.exists(fp):
        return []
    with open(fp) as f:
        return json.load(f)


def tokenizer_path(path: str) -> str:
    return os.path.join(path, "tokenizer.json")
