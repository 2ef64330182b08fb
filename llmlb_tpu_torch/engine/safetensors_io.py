"""A small reader and writer of the safetensors format, with numpy and torch
only (the `safetensors` package is not a dependency of the port).

A file is an 8-byte little-endian header length N, N bytes of JSON header
`{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin, end]}}`
(offsets into the data that follows; an optional `__metadata__` entry of
strings), then the tensors' raw little-endian bytes. F32, F16 and BF16 are
read and written.

`SafetensorsFile(path)` has the interface of the readers the JAX package
opens (`keys()`, `get_tensor(name)`, `close()`): `get_tensor` returns a
float32 numpy array. `get_torch(name)` returns a CPU tensor of the stored
dtype (BF16 read as int16 and reinterpreted, never widened), which is what
the checkpoint loader streams. Either reads one tensor from the file when
asked for.

`save_file` writes the header from the tensors' shapes and dtypes, then
each tensor's bytes in turn (a CUDA tensor is copied to the host when its
turn comes), so a shard never sits in host memory whole. `save_sharded`
spreads a checkpoint over several such files with the
`model.safetensors.index.json` that HF writes beside them.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

INDEX_NAME = "model.safetensors.index.json"

_NP_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
              "BF16": np.dtype("<i2")}
_TORCH_CODES = {torch.float32: "F32", torch.float16: "F16",
                torch.bfloat16: "BF16"}
_ITEMSIZE = {"F32": 4, "F16": 2, "BF16": 2}


def read_header(path: str) -> tuple[dict, int]:
    """({name: {"dtype", "shape", "data_offsets"}}, the data's start) of a
    .safetensors file, `__metadata__` left out; any dtype code is kept."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsFile:
    """Lazy reader of one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        # a tensor of another dtype is listed, and refused when read
        self._header, self._data_start = read_header(path)

    def keys(self) -> list[str]:
        return list(self._header)

    def _raw(self, name: str) -> tuple[np.ndarray, str]:
        entry = self._header[name]
        if entry["dtype"] not in _NP_DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{entry['dtype']} (F32, F16 or BF16 read)")
        dtype = _NP_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = (end - begin) // dtype.itemsize
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{self.path}: tensor {name!r} holds {count} "
                             f"elements, shape {shape}")
        raw = np.fromfile(self.path, dtype=dtype, count=count,
                          offset=self._data_start + begin).reshape(shape)
        return raw, entry["dtype"]

    def get_torch(self, name: str) -> torch.Tensor:
        """The tensor in its stored dtype, on the host."""
        raw, code = self._raw(name)
        t = torch.from_numpy(raw)
        return t.view(torch.bfloat16) if code == "BF16" else t

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor widened to a float32 numpy array."""
        return self.get_torch(name).float().numpy()

    def close(self) -> None:
        pass


def _code_and_shape(name: str, value) -> tuple[str, list[int]]:
    if isinstance(value, torch.Tensor):
        if value.dtype not in _TORCH_CODES:
            raise TypeError(f"tensor {name!r}: dtype {value.dtype} not written")
        return _TORCH_CODES[value.dtype], list(value.shape)
    arr = np.asarray(value)
    code = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}.get(
        arr.dtype)
    if code is None and arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        code = "BF16"
    if code is None:
        raise TypeError(f"tensor {name!r}: dtype {arr.dtype} not written")
    return code, list(arr.shape)


def _bytes_of(value) -> bytes:
    """The little-endian bytes of one tensor, C order (a strided view is
    copied contiguous first: the bytes must be the shape's, not the
    buffer's)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu()
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    else:
        data = np.asarray(value)
        if data.dtype.name == "bfloat16":
            data = data.view(np.int16)
    data = np.ascontiguousarray(data)
    return data.astype(data.dtype.newbyteorder("<"), copy=False).tobytes()


def save_file(tensors: dict, path: str) -> None:
    """Write `{name: tensor}` as one .safetensors file. A value is a numpy
    float32/float16/bfloat16 array or a torch float32/float16/bfloat16
    tensor on any device. Tensors are laid out in the given order, each
    right after the previous, and the header is padded with spaces to a
    multiple of 8 bytes, as the safetensors package writes it."""
    header, offset = {}, 0
    for name, value in tensors.items():
        code, shape = _code_and_shape(name, value)
        nbytes = int(np.prod(shape, dtype=np.int64)) * _ITEMSIZE[code]
        header[name] = {"dtype": code, "shape": shape,
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, value in tensors.items():
            blob = _bytes_of(value)
            begin, end = header[name]["data_offsets"]
            if len(blob) != end - begin:
                raise ValueError(f"tensor {name!r}: {len(blob)} bytes, the "
                                 f"header says {end - begin}")
            f.write(blob)


def save_sharded(tensors: dict, model_dir: str, shards: int) -> list[str]:
    """Write `{name: tensor}` as `shards` files of about equal bytes
    (`model-0000i-of-0000n.safetensors`, tensors in the given order) and
    the index HF writes beside them: `{"metadata": {"total_size": ...},
    "weight_map": {name: file}}`. Returns the file names."""
    names = list(tensors)
    sizes = []
    for name in names:
        code, shape = _code_and_shape(name, tensors[name])
        sizes.append(int(np.prod(shape, dtype=np.int64)) * _ITEMSIZE[code])
    total = sum(sizes)
    files = [f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
             for i in range(shards)]
    weight_map, groups, acc = {}, [[] for _ in range(shards)], 0
    for name, size in zip(names, sizes):
        # the shard whose share of the total this tensor starts in
        i = min(shards - 1, acc * shards // max(1, total))
        groups[i].append(name)
        weight_map[name] = files[i]
        acc += size
    for fname, group in zip(files, groups):
        save_file({n: tensors[n] for n in group},
                  os.path.join(model_dir, fname))
    with open(os.path.join(model_dir, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return files
