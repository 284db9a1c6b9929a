"""Checkpointing: trees -> msgpack files with dtype/shape-preserving codecs,
the port of ``src/repro/checkpoint/msgpack_ckpt.py`` in the same file
layout, so that a file saved by either side loads in the other.

Layout: <dir>/step_<N>.msgpack, atomic writes via tmp+fsync+rename (the file
is durable before it becomes visible, so a crash mid-save never leaves a
half-written step under the canonical name), ``latest_step`` for resumption,
optional keep-last-N retention so watchdog rollback anchors don't accumulate
unboundedly.  ``load`` rejects truncated or corrupt files loudly, naming the
file, instead of returning a garbage tree.  Handles nested dict/list/tuple
trees of tensors, numpy arrays and Python scalars.

An array is a map ``{"__arr__": True, "dtype": numpy's name, "shape",
"data": its bytes}``, a list or tuple ``{"__tup__": is_tuple, "items"}``.
bfloat16, which numpy lacks, travels as its 16-bit words under the dtype
name "bfloat16" (what the reference's ``ml_dtypes`` writes) and loads as a
``torch.bfloat16`` tensor.  float64 arrays load as writable numpy (the
popstore's running sums, as the reference keeps them); other arrays load
as CPU tensors.

Large arrays (anything over ``CHUNK_BYTES``, notably the host-resident
population store's (m, width) buffers at m=10^6) are streamed: the tree is
written as a small skeleton object with per-array placeholders
(``{"__chunked__": True, "dtype", "shape", "id"}``), followed by each
array's header ``{"id", "n_chunks"}`` and its bytes in chunks of
``CHUNK_BYTES`` appended to the same msgpack stream.  Peak transient memory
during save/load is therefore O(CHUNK_BYTES), not O(state).  Streamed
arrays load back as host numpy arrays (bfloat16: CPU tensors).

The codec is ``_msgpack`` (the card's machine has no ``msgpack``).
"""
from __future__ import annotations

import math
import os
import pathlib
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

_ARR = "__arr__"
_TUP = "__tup__"
_CHUNKED = "__chunked__"

# Arrays above this size stream in chunks of this many bytes.
CHUNK_BYTES = 16 << 20

_BF16 = "bfloat16"


def _host(x):
    """An array leaf as (numpy array of its bytes, dtype name): a tensor is
    moved to the host, bfloat16 as its int16 words."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _is_array(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes


def _encode(obj):
    if _is_array(obj):
        arr, dtype = _host(obj)
        return {_ARR: True, "dtype": dtype, "shape": list(arr.shape), "data": arr.tobytes()}
    return obj


def _pack(tree):
    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return {_TUP: isinstance(t, tuple), "items": [rec(v) for v in t]}
        return _encode(t)

    return rec(tree)


def _np_dtype(name: str):
    return np.dtype(np.int16) if name == _BF16 else np.dtype(name)


def _from_words(arr: np.ndarray, name: str):
    """A loaded array as the port keeps it (see the module doc)."""
    if name == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _unpack(obj):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            arr = np.frombuffer(obj["data"], dtype=_np_dtype(obj["dtype"]))
            arr = arr.reshape(obj["shape"]).copy()  # writable: frombuffer views are read-only
            if arr.dtype == np.float64:
                return arr  # host-only state (the popstore's running sums)
            if obj["dtype"] == _BF16:
                return _from_words(arr, _BF16)
            return torch.from_numpy(arr)
        if _TUP in obj:
            items = [_unpack(v) for v in obj["items"]]
            return tuple(items) if obj[_TUP] else items
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def _split_large(tree):
    """Replace every array larger than ``CHUNK_BYTES`` with a placeholder
    dict; returns ``(skeleton, ordered list of the extracted arrays)``."""
    big: list = []

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            vals = [rec(v) for v in t]
            return tuple(vals) if isinstance(t, tuple) else vals
        if _is_array(t) and _nbytes(t) > CHUNK_BYTES:
            arr, dtype = _host(t)
            big.append(arr)
            return {_CHUNKED: True, "dtype": dtype, "shape": list(arr.shape),
                    "id": len(big) - 1}
        return t

    return rec(tree), big


def _graft(obj, slots):
    """Swap restored chunked arrays back into their placeholder positions."""
    if isinstance(obj, dict):
        if obj.get(_CHUNKED):
            return slots[obj["id"]]
        return {k: _graft(v, slots) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_graft(v, slots) for v in obj]
        return tuple(vals) if isinstance(obj, tuple) else vals
    return obj


def save(path: str | os.PathLike, step: int, tree: Any, *,
         keep: Optional[int] = None) -> str:
    """Write ``step`` atomically; with ``keep``, prune all but the newest
    ``keep`` checkpoints afterwards.  Arrays over ``CHUNK_BYTES`` stream to
    the file in bounded chunks."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    final = path / f"step_{step:08d}.msgpack"
    tmp = final.with_suffix(".tmp")
    skeleton, big = _split_large(tree)
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(_pack(skeleton)))
        for k, arr in enumerate(big):
            flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            n_chunks = max(1, math.ceil(arr.nbytes / CHUNK_BYTES))
            f.write(_msgpack.packb({"id": k, "n_chunks": n_chunks}))
            for c in range(n_chunks):
                chunk = flat[c * CHUNK_BYTES:(c + 1) * CHUNK_BYTES]
                f.write(_msgpack.bin_header(chunk.nbytes))  # packb(bytes), with no copy
                f.write(chunk.data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    if keep is not None and keep > 0:
        for n in steps(path)[:-keep]:
            (path / f"step_{n:08d}.msgpack").unlink(missing_ok=True)
    return str(final)


def _parse_step(p: pathlib.Path) -> Optional[int]:
    stem = p.stem
    suffix = stem.split("_", 1)[1] if "_" in stem else ""
    return int(suffix) if suffix.isdigit() else None


def steps(path: str | os.PathLike) -> list[int]:
    """All on-disk checkpoint steps, ascending.  Files matching the glob
    with a non-numeric suffix are skipped with a warning, not raised on."""
    path = pathlib.Path(path)
    if not path.exists():
        return []
    out = []
    for p in path.glob("step_*.msgpack"):
        n = _parse_step(p)
        if n is None:
            warnings.warn(f"[ckpt] ignoring non-checkpoint file {p} (suffix is not a "
                          f"step number)", RuntimeWarning, stacklevel=2)
            continue
        out.append(n)
    return sorted(out)


def latest_step(path: str | os.PathLike) -> Optional[int]:
    all_steps = steps(path)
    return all_steps[-1] if all_steps else None


class _Corrupt(Exception):
    pass


def load(path: str | os.PathLike, step: Optional[int] = None) -> Any:
    path = pathlib.Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fp = path / f"step_{step:08d}.msgpack"
    if not fp.exists():
        raise FileNotFoundError(f"no checkpoint file {fp}")
    try:
        with open(fp, "rb") as f:
            unp = _msgpack.Unpacker(f)
            payload = _unpack(unp.unpack())
            slots_meta: dict = {}
            _index_chunked(payload, slots_meta)
            if not slots_meta:
                _expect_eof(unp)
                return payload
            # streamed tail: per-array header + bounded chunks, in the order
            # the writer extracted them, into preallocated host buffers
            slots = {}
            for _ in range(len(slots_meta)):
                hdr = unp.unpack()
                ph = slots_meta[int(hdr["id"])]
                arr = np.empty([int(s) for s in ph["shape"]], dtype=_np_dtype(ph["dtype"]))
                flat = memoryview(arr.reshape(-1).view(np.uint8))
                off = 0
                for _c in range(int(hdr["n_chunks"])):
                    off += unp.unpack_bin_into(flat[off:])
                if off != arr.nbytes:
                    raise _Corrupt(f"chunked array id={hdr['id']} has {off} bytes, "
                                   f"expected {arr.nbytes}")
                slots[int(hdr["id"])] = _from_words(arr, ph["dtype"])
            _expect_eof(unp)
            return _graft(payload, slots)
    except Exception as e:
        raise ValueError(
            f"checkpoint {fp} is truncated or corrupt ({fp.stat().st_size} bytes): {e}; "
            f"delete it and resume from an earlier step") from e


def _expect_eof(unp):
    """The file must hold exactly the checkpoint stream: trailing bytes
    mean a corrupt or foreign file."""
    try:
        unp.unpack()
    except _msgpack.OutOfData:
        return
    raise _Corrupt("trailing data after checkpoint payload")


def _index_chunked(obj, out: dict):
    """Collect chunked-array placeholders by id into ``out``."""
    if isinstance(obj, dict):
        if obj.get(_CHUNKED):
            out[int(obj["id"])] = obj
            return
        for v in obj.values():
            _index_chunked(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _index_chunked(v, out)
