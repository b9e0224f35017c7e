"""Checkpoints in the JAX package's on-disk layout (its
``checkpoint/io.py``), so that either package restores the other's:

    <dir>/<step:08d>/state.msgpack + meta.json

``state.msgpack`` is one msgpack map ``{"leaves": [leaf, ...], "treedef":
str}``, each leaf a map ``{"dtype": numpy's dtype name, "shape": [ints],
"data": raw little-endian bytes}``, bfloat16 stored as its uint16 bits
under the dtype name ``"bfloat16"``. The leaves are in the reference's
flatten order: a dict's keys sorted, a tuple's or list's items in order.
The port's flat dicts, whose sorted "/"-joined keys are the reference's
leaf order (``convert.py``), give the reference's leaves for the
reference's tree — a train state ``(params, opt_state, step)`` is the
parameters, then the optimizer's moments (``m/…`` then ``v/…``, or
Adafactor's ``s/…``), then the step as a 0-d int32. ``treedef`` is only
written, never read (the reference writes its own tree's description
there and, like the port, restores into the structure of a ``like``
tree).

The msgpack package is not a dependency of the port: this module encodes
and decodes the subset the reference writes — maps, arrays, str, bin and
non-negative ints, in every width msgpack uses for them.
"""
from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, BinaryIO, List, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


# ---------------------------------------------------------------------- #
# msgpack, the subset the reference's checkpoints hold
# ---------------------------------------------------------------------- #
def _pack(obj, out: BinaryIO) -> None:
    """Write ``obj`` (dict / list / tuple / str / bytes / int >= 0) to
    ``out`` in msgpack's shortest form, as ``msgpack.packb(…,
    use_bin_type=True)`` writes it."""
    if isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, 0xDC, 0xDD)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.write(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.write(bytes([0xD9, n]))
        else:
            _header(out, n, None, 0, 0xDA, 0xDB)
        out.write(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        if n < 1 << 8:
            out.write(bytes([0xC4, n]))
        else:
            _header(out, n, None, 0, 0xC5, 0xC6)
        out.write(obj)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 0x80:
            out.write(bytes([obj]))
        elif obj < 1 << 8:
            out.write(bytes([0xCC, obj]))
        elif obj < 1 << 16:
            out.write(b"\xcd" + struct.pack(">H", obj))
        elif obj < 1 << 32:
            out.write(b"\xce" + struct.pack(">I", obj))
        else:
            out.write(b"\xcf" + struct.pack(">Q", obj))
    else:
        raise TypeError(f"checkpoint codec cannot pack {type(obj).__name__}"
                        f" {obj!r:.40}")


def _header(out, n, fix_base, fix_limit, code16, code32) -> None:
    """A map/array/str/bin length: the fix form below ``fix_limit``, else
    16 or 32 bits after its code."""
    if fix_base is not None and n < fix_limit:
        out.write(bytes([fix_base | n]))
    elif n < 1 << 16:
        out.write(bytes([code16]) + struct.pack(">H", n))
    else:
        out.write(bytes([code32]) + struct.pack(">I", n))


def _unpack(buf: memoryview, i: int = 0):
    """(the object at ``buf[i]``, the index after it); str decoded as
    UTF-8, bin as a memoryview of ``buf``."""
    c = buf[i]
    if c < 0x80:
        return c, i + 1
    if 0x80 <= c <= 0x8F:
        return _unpack_map(buf, i + 1, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return _unpack_array(buf, i + 1, c & 0x0F)
    if 0xA0 <= c <= 0xBF:
        n = c & 0x1F
        return bytes(buf[i + 1:i + 1 + n]).decode("utf-8"), i + 1 + n
    width = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8,     # uint
             0xC4: 1, 0xC5: 2, 0xC6: 4,              # bin
             0xD9: 1, 0xDA: 2, 0xDB: 4,              # str
             0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}     # array, map
    if c not in width:
        raise ValueError(f"checkpoint codec: unsupported msgpack type "
                         f"0x{c:02x} at byte {i}")
    w = width[c]
    n = int.from_bytes(buf[i + 1:i + 1 + w], "big")
    j = i + 1 + w
    if c in (0xCC, 0xCD, 0xCE, 0xCF):
        return n, j
    if c in (0xC4, 0xC5, 0xC6):
        return buf[j:j + n], j + n
    if c in (0xD9, 0xDA, 0xDB):
        return bytes(buf[j:j + n]).decode("utf-8"), j + n
    if c in (0xDC, 0xDD):
        return _unpack_array(buf, j, n)
    return _unpack_map(buf, j, n)


def _unpack_array(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (the subset above)."""
    out = io.BytesIO()
    _pack(obj, out)
    return out.getvalue()


def unpackb(data) -> Any:
    """The object msgpack ``data`` holds (the subset above); bin values
    come back as bytes."""
    return _bytes_out(_unpack_whole(data))


def _unpack_whole(data):
    """The one object ``data`` holds, bin values as memoryviews of it;
    ``ValueError`` if bytes follow it."""
    obj, end = _unpack(memoryview(data))
    if end != len(data):
        raise ValueError(f"checkpoint codec: {len(data) - end} bytes after "
                         "the object")
    return obj


def _bytes_out(obj):
    if isinstance(obj, dict):
        return {k: _bytes_out(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_bytes_out(v) for v in obj]
    return bytes(obj) if isinstance(obj, memoryview) else obj


# ---------------------------------------------------------------------- #
# Trees
# ---------------------------------------------------------------------- #
def _leaves(tree) -> List[Any]:
    """The leaves in the reference's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(like, it):
    """``like``'s structure with its leaves replaced from ``it``, in
    flatten order (a dict keeps its own key order)."""
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _encode_leaf(x: torch.Tensor) -> dict:
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return {"dtype": _BF16, "shape": list(x.shape),
                "data": x.view(torch.int16).numpy().tobytes()}
    arr = x.numpy()
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode_leaf(d: dict, like: torch.Tensor) -> torch.Tensor:
    """The leaf ``d`` on ``like``'s device; its dtype and shape must be
    ``like``'s (``ValueError`` otherwise)."""
    shape = tuple(d["shape"])
    if d["dtype"] == _BF16:
        dtype = torch.bfloat16
        t = (torch.frombuffer(bytearray(d["data"]), dtype=dtype)
             if len(d["data"]) else torch.empty(0, dtype=dtype))
    else:
        t = torch.from_numpy(np.frombuffer(d["data"], np.dtype(d["dtype"]))
                             .copy())
    if t.dtype != like.dtype or shape != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {d['dtype']} {list(shape)} does "
                         f"not match {like.dtype} {list(like.shape)}")
    return t.reshape(shape).to(like.device)


def save_pytree(tree: Any, path: str) -> None:
    """Write ``tree``'s tensors (nested dicts, tuples and lists) to
    ``path`` in the reference's msgpack layout, leaf by leaf."""
    leaves = _leaves(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        # {"leaves": [...], "treedef": ...}, the map written piecewise so
        # that no second copy of the leaves' bytes is made
        _header(f, 2, 0x80, 16, 0xDE, 0xDF)
        _pack("leaves", f)
        _header(f, len(leaves), 0x90, 16, 0xDC, 0xDD)
        for x in leaves:
            _pack(_encode_leaf(x), f)
        _pack("treedef", f)
        _pack(f"repro_torch tree of {len(leaves)} leaves", f)


def load_pytree(like: Any, path: str) -> Any:
    """The tree at ``path`` in ``like``'s structure, each leaf on the
    device of ``like``'s; ``ValueError`` when the leaf count, a dtype or a
    shape differs."""
    with open(path, "rb") as f:
        stored = _unpack_whole(f.read())["leaves"]
    want = _leaves(like)
    if len(stored) != len(want):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected "
                         f"{len(want)}")
    return _rebuild(like, iter([_decode_leaf(d, w)
                                for d, w in zip(stored, want)]))


def save(ckpt_dir: str, step: int, state: Any,
         meta: Optional[dict] = None) -> None:
    d = os.path.join(ckpt_dir, f"{step:08d}")
    os.makedirs(d, exist_ok=True)
    save_pytree(state, os.path.join(d, "state.msgpack"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n) for n in os.listdir(ckpt_dir) if n.isdigit()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """(the state saved at ``step`` — default the latest — in ``like``'s
    structure, its meta dict), or (None, None) where there is none."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"{step:08d}")
    state = load_pytree(like, os.path.join(d, "state.msgpack"))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return state, meta
