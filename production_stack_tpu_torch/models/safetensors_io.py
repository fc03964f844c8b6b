"""The safetensors file format, read and written without the
``safetensors`` package (the card's machine has none).

Counterpart of the reading half of
``production_stack_tpu/models/weights.py:_iter_checkpoint_tensors``, which
goes through ``safetensors.safe_open``. A file is an 8-byte little-endian
header length N, N bytes of JSON (``{name: {"dtype", "shape",
"data_offsets": [begin, end]}, "__metadata__": {...}}``, offsets relative
to the first byte after the header), then the raw little-endian tensor
bytes. The reader memory-maps one tensor at a time, read-only, and hands it
out as a CPU tensor over the map, with no copy (bf16 through an int16
view); the map is closed once the consumer has moved on, so a loader that
copies each tensor to the device holds about one tensor of host memory,
not the file. The writer writes the same format (the header padded with spaces to
a multiple of 8 bytes, as the package does); the smoke script and the
tests write checkpoints and PEFT adapters with it.
"""

import json
import mmap
import os
import struct
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# safetensors dtype name -> torch dtype
_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_NAMES = {v: k for k, v in _DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def read_header(path: str) -> Tuple[Dict, int]:
    """(the header's JSON object, the byte offset where tensor data
    starts)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    return header, 8 + n


def _check_entry(path: str, name: str, entry: Dict, data_len: int) -> None:
    if entry["dtype"] not in _DTYPES:
        raise ValueError(f"{path}: tensor {name!r} has dtype "
                         f"{entry['dtype']!r}, not one of {sorted(_DTYPES)}")
    begin, end = entry["data_offsets"]
    n = 1
    for s in entry["shape"]:
        n *= s
    want = n * _DTYPES[entry["dtype"]].itemsize
    if end - begin != want or not 0 <= begin <= end <= data_len:
        raise ValueError(f"{path}: tensor {name!r} spans bytes "
                         f"[{begin}, {end}) of {data_len}, its shape and "
                         f"dtype need {want}")


def iter_file(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) for every tensor of the file, in header
    order. Each tensor views a read-only memory map of its own bytes:
    copy it before the next ``next()``; the map is closed then, or when
    the consumer drops its last reference to the tensor."""
    header, start = read_header(path)
    size = os.path.getsize(path)
    entries = [(k, v) for k, v in header.items() if k != "__metadata__"]
    for name, entry in entries:
        _check_entry(path, name, entry, size - start)
    grain = mmap.ALLOCATIONGRANULARITY
    with open(path, "rb") as f:
        for name, entry in entries:
            begin, end = (start + o for o in entry["data_offsets"])
            dtype = _DTYPES[entry["dtype"]]
            shape = tuple(entry["shape"])
            if end == begin:
                yield name, torch.empty(shape, dtype=dtype)
                continue
            # One map per tensor, unmapped once it is consumed: the host
            # holds about one tensor of the file at a time (dropping pages
            # of one long-lived map does not shrink the resident set on
            # every kernel).
            lo = begin // grain * grain
            mm = mmap.mmap(f.fileno(), end - lo, access=mmap.ACCESS_READ,
                           offset=lo)
            view = torch.int16 if dtype == torch.bfloat16 else dtype
            with warnings.catch_warnings():
                # A read-only map: torch warns that the tensor must not be
                # written, which no reader does.
                warnings.simplefilter("ignore", UserWarning)
                t = torch.frombuffer(mm, dtype=view,
                                     count=(end - begin) // view.itemsize,
                                     offset=begin - lo).view(dtype)
            yield name, t.view(shape)
            del t
            try:
                mm.close()
            except BufferError:
                pass  # still viewed: unmapped with the consumer's last view
            del mm


def checkpoint_files(model_dir: str) -> List[str]:
    """The safetensors files of a checkpoint directory: those the index
    (``model.safetensors.index.json``) names when there is one, else every
    ``*.safetensors``, sorted."""
    index = os.path.join(model_dir, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return [os.path.join(model_dir, n) for n in sorted(set(weight_map.values()))]
    return [os.path.join(model_dir, n) for n in sorted(os.listdir(model_dir))
            if n.endswith(".safetensors")]


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (CPU or device; any of the format's dtypes) as one
    safetensors file, in the dict's order; returns the bytes written."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             "safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.numpy()).cast("B") if t.numel() else b"")
    return 8 + len(raw) + off


def save_sharded(tensors: Dict[str, torch.Tensor], model_dir: str,
                 num_shards: int) -> List[str]:
    """Write ``tensors`` as ``num_shards`` files of about equal bytes,
    ``model-0000i-of-0000n.safetensors``, and the index that maps each
    name to its file (HF's layout of a sharded checkpoint). Returns the
    file names."""
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    per = total / max(1, num_shards)
    groups: List[Dict[str, torch.Tensor]] = [{} for _ in range(num_shards)]
    acc = 0
    for name, t in tensors.items():
        groups[min(num_shards - 1, int(acc // per))][name] = t
        acc += t.numel() * t.element_size()
    names = [f"model-{i + 1:05d}-of-{num_shards:05d}.safetensors"
             for i in range(num_shards)]
    weight_map = {}
    for fname, group in zip(names, groups):
        save_file(group, os.path.join(model_dir, fname), {"format": "pt"})
        weight_map.update({k: fname for k in group})
    with open(os.path.join(model_dir, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map},
                  f, indent=2)
    return names
