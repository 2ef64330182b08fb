"""A small reader and writer of the safetensors format, with numpy and torch
only (the `safetensors` package is not a dependency of the port).

A file is an 8-byte little-endian header length N, N bytes of JSON header
`{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin, end]}}`
(offsets into the data that follows; an optional `__metadata__` entry of
strings), then the tensors' raw little-endian bytes. F32, F16 and BF16 are
read and written. numpy has no bfloat16, so BF16 is read as uint16 and
widened through torch.

`SafetensorsFile(path)` has the interface of the readers the JAX package
opens (`keys()`, `get_tensor(name)`, `close()`): `get_tensor` returns a
float32 numpy array, read from the file when asked for.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_NP_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
              "BF16": np.dtype("<u2")}
_TORCH_CODES = {torch.float32: "F32", torch.float16: "F16",
                torch.bfloat16: "BF16"}


class SafetensorsFile:
    """Lazy reader of one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._data_start = 8 + n
        header.pop("__metadata__", None)
        for name, entry in header.items():
            if entry["dtype"] not in _NP_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{entry['dtype']} (F32, F16 or BF16 read)")
        self._header = header

    def keys(self) -> list[str]:
        return list(self._header)

    def get_tensor(self, name: str) -> np.ndarray:
        entry = self._header[name]
        dtype = _NP_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = (end - begin) // dtype.itemsize
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{self.path}: tensor {name!r} holds {count} "
                             f"elements, shape {shape}")
        raw = np.fromfile(self.path, dtype=dtype, count=count,
                          offset=self._data_start + begin).reshape(shape)
        if entry["dtype"] == "BF16":
            return torch.from_numpy(raw.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        return raw.astype(np.float32)

    def close(self) -> None:
        pass


def save_file(tensors: dict, path: str) -> None:
    """Write `{name: tensor}` as one .safetensors file. A value is a numpy
    float32/float16 array or a torch float32/float16/bfloat16 tensor
    (copied to the CPU). Tensors are laid out in the given order, each
    right after the previous, and the header is padded with spaces to a
    multiple of 8 bytes, as the safetensors package writes it."""
    header, blobs, offset = {}, [], 0
    for name, value in tensors.items():
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu().contiguous()
            if t.dtype not in _TORCH_CODES:
                raise TypeError(f"tensor {name!r}: dtype {t.dtype} not written")
            code = _TORCH_CODES[t.dtype]
            data = (t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t).numpy()
        else:
            arr = np.asarray(value)
            code = {np.dtype(np.float32): "F32",
                    np.dtype(np.float16): "F16"}.get(arr.dtype)
            if code is None:
                raise TypeError(f"tensor {name!r}: dtype {arr.dtype} not "
                                "written")
            data = arr
        blob = np.ascontiguousarray(data).astype(
            data.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": code, "shape": list(data.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
