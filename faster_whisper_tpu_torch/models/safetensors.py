"""The safetensors file format, read and written with numpy alone.

A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`` and then the raw little-endian bytes, the offsets counted from the
end of the header.  Reading maps the file into memory: each tensor is a
view of the mapping, and only what the caller converts is read from disk.
"""

import json
import struct

from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),  # widened to float32 on reading
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a safetensors file.  The arrays are read-only
    views of the file mapped into memory; BF16 tensors are widened to
    float32 (exact)."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if data.size < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    if 8 + n > data.size:
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(bytes(data[8 : 8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape)) if shape else 1
        if end - begin != count * dtype.itemsize or base + end > data.size:
            raise ValueError(f"{path}: tensor {name!r}: offsets {begin}..{end} do not hold {shape} {info['dtype']}")
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=base + begin).reshape(shape)
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def save_file(tensors: Dict[str, np.ndarray], path: str, metadata: Optional[dict] = None) -> None:
    """Write ``tensors`` (numpy arrays of the dtypes above but BF16) as a
    safetensors file, in the order given."""
    header = {}
    offset = 0
    arrays = {}
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        kind = _NAMES.get(arr.dtype)
        if kind is None:
            raise ValueError(f"tensor {name!r}: dtype {arr.dtype} has no safetensors name")
        header[name] = {"dtype": kind, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays[name] = arr
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)  # align the data to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for arr in arrays.values():
            f.write(arr.tobytes())
