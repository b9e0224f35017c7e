"""Partition rules: params / optimizer state / batches / decode caches.

Baseline layout (single pod 16x16, axes ("data", "model")):
  * Megatron-style tensor parallelism over ``model``: attention head
    projections and MLP hidden dims are column/row sharded.
  * Batch (and MoE dispatch) over ``data``; multi-pod adds a leading ``pod``
    axis that extends the batch sharding.
  * MoE experts: ``(data x model)``-sharded when E divides the full mesh
    (DeepSeek's 256), else expert dim over ``model`` with the expert FFN dim
    over ``data`` (Jamba's 16 x 24576, Moonlight/Qwen's 6x/15x 1408) — this is
    what fits the 398B/671B configs in 16 GB/chip.
  * Optimizer moments: ZeRO-style — the first unsharded, divisible dim is
    additionally sharded over ``data``.
  * Decode caches: batch over ``data`` when divisible, sequence over
    ``model`` (GQA kv-head counts are below 16, so head-sharding the cache is
    not viable); batch=1 long-context shards sequence over the whole mesh.

All rules return PartitionSpecs; GSPMD pads non-divisible dims (e.g. Qwen's 60
experts, vocab 50280) — correctness is unaffected, the dry-run prices it.

(The JAX package's own words above, its rules unchanged. In the port a
spec is a tuple with one entry per tensor dim — ``None``, an axis name, or
a tuple of axis names, a one-name tuple written as the bare name, as
``PartitionSpec`` writes it — and the entries that do not divide their dim
are dropped by ``_fix``, so no padding arises. The rules read only a
mesh's axis names and sizes: a ``MeshShape``, or a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_shape`` converts), so
they need no process group. ``named`` turns a spec into DTensor
placements on a ``DeviceMesh``.)

The trees are the port's flat dicts, keyed by the "/"-joined tree paths of
the JAX package (``blocks/layers/0/mixer/wq``; an optimizer's
``m/<leaf>``, ``v/<leaf>``, ``s/<leaf>/vr``; a cache's
``blocks/layers/0/k`` and its host-int ``index``), so a rule sees the
same path names as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

from repro_torch.configs.base import InputShape, ModelConfig

Spec = Tuple

# parameter-name rule tables (trailing dims, before the scan-stack prefix)
_COL = {"wq", "wk", "wv", "wg", "wu", "in_proj", "wuq", "wuk", "wuv", "wdq",
        "proj", "src_proj", "embed", "lm_head", "conv_w"}
_ROW = {"wo", "wd", "out_proj"}
_VEC_MODEL = {"bq", "bk", "bv", "conv_b", "A_log", "D", "dt_bias"}
_REPL = {"router", "wkr", "wdkv", "norm1", "norm2", "norm_x", "final_norm",
         "enc_norm", "q_norm", "k_norm", "kv_norm", "norm_h", "norm_e"}
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, in mesh order, without devices:
    what the rules read (``axis_names``, and ``shape`` as a mapping from
    axis name to size, as a JAX ``Mesh`` has them)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``MeshShape`` or a ``DeviceMesh`` (its
    ``mesh_dim_names`` and the size of each dim)."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"a mesh needs named axes, got {mesh!r}")
    return MeshShape(tuple(names), tuple(mesh.size(i)
                                         for i in range(len(names))))


def _spec(*entries) -> Spec:
    """A spec, each one-name tuple written as the bare name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _path_names(key: str) -> list:
    """A flat key's path: names as strings, tuple indices as ints."""
    return [int(p) if p.isdigit() else p for p in key.split("/")]


def _leaf_name(names) -> str:
    return next((n for n in reversed(names) if isinstance(n, str)), "")


def _is_stacked(names) -> bool:
    return any(n in _STACKS for n in names if isinstance(n, str))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh).axis_names
                 if a in ("pod", "data"))


def _expert_spec(name: str, shape, mesh) -> Spec:
    """(E, d, f) / (E, f, d) expert tensors."""
    E = shape[0]
    total = mesh_shape(mesh).size
    dax = data_axes(mesh)
    if E % total == 0:
        return _spec((*dax, "model"), None, None)
    if name in ("wg", "wu"):
        return _spec("model", None, dax)
    return _spec("model", dax, None)          # wd: (E, f, d)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = mesh_shape(mesh).shape
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def _fix(spec: Spec, shape, mesh) -> Spec:
    """Drop spec entries that do not evenly divide the dim (NamedSharding on
    inputs requires exact divisibility); if a 2D+ weight loses its only
    sharded dim, fall back to sharding the first divisible dim over model."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = [s if shape[i] % _axis_size(mesh, s) == 0 else None
             for i, s in enumerate(parts)]
    if any(fixed) or not any(parts):
        return _spec(*fixed)
    model = mesh_shape(mesh).shape["model"]
    for i, dim in enumerate(shape):              # fallback: row-shard
        if dim % model == 0 and dim >= model:
            fixed[i] = "model"
            break
    return _spec(*fixed)


def param_rule(key: str, shape, cfg: ModelConfig, mesh) -> Spec:
    """The spec of the parameter at flat key ``key`` of shape ``shape``."""
    names = _path_names(key)
    name = _leaf_name(names)
    stacked = _is_stacked(names)
    shape = tuple(shape)
    core = shape[1:] if stacked else shape
    nd = len(core)

    if name in ("wg", "wu", "wd") and nd == 3:       # routed experts
        spec = _expert_spec(name, core, mesh)
    elif name == "norm" and nd == 1:                 # ssm gated norm (d_in,)
        spec = _spec("model")
    elif name in _VEC_MODEL:
        spec = _spec("model") if nd == 1 else _spec(None, "model")
    elif name in _ROW:
        spec = _spec("model", *([None] * (nd - 1)))
    elif name in _COL:
        spec = _spec(*([None] * (nd - 1)), "model")
    else:                                            # _REPL, scalars, rest
        spec = _spec(*([None] * nd))
    if stacked:
        spec = _spec(None, *spec)
    return _fix(spec, shape, mesh)


def param_specs(cfg: ModelConfig, params: Mapping, mesh) -> Dict[str, Spec]:
    """{flat key: spec} of a flat params dict (tensors of any device,
    ``meta`` included: only shapes are read)."""
    return {k: param_rule(k, p.shape, cfg, mesh) for k, p in params.items()}


# ---------------------------------------------------------------------- #
# Optimizer state: ZeRO the first unsharded divisible dim over data
# ---------------------------------------------------------------------- #
def _zero_shard(spec: Spec, shape, mesh) -> Spec:
    dax = data_axes(mesh)
    n = _axis_size(mesh, dax)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for s in parts:
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    if used & set(dax):               # expert tensors already span data
        return _spec(*parts)
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % n == 0 and dim >= n:
            parts[i] = dax if len(dax) > 1 else dax[0]
            break
    return _spec(*parts)


def opt_state_specs(opt_name: str, params: Mapping, pspecs: Mapping,
                    mesh) -> Dict[str, Spec]:
    """{flat key: spec} of the optimizer state ``optim.make_optimizer``
    builds for ``params``: ``m/<leaf>`` (momentum, Adam, AdamW),
    ``v/<leaf>`` (Adam, AdamW), Adafactor's ``s/<leaf>/vr`` and
    ``s/<leaf>/vc`` (2-D and up) or ``s/<leaf>/v``; SGD none."""
    def like(k):
        return _zero_shard(pspecs[k], params[k].shape, mesh)

    if opt_name in ("sgd",):
        return {}
    if opt_name in ("momentum",):
        return {f"m/{k}": like(k) for k in params}
    if opt_name in ("adam", "adamw"):
        m = {k: like(k) for k in params}
        return {**{f"m/{k}": s for k, s in m.items()},
                **{f"v/{k}": s for k, s in m.items()}}
    if opt_name == "adafactor":
        out = {}
        for k, p in params.items():
            parts = list(pspecs[k]) + [None] * (p.dim() - len(pspecs[k]))
            if p.dim() >= 2:
                out[f"s/{k}/vr"] = _spec(*parts[:-1])
                out[f"s/{k}/vc"] = _spec(*parts[:-2], parts[-1])
            else:
                out[f"s/{k}/v"] = _spec(*parts)
        return out
    raise KeyError(opt_name)


# ---------------------------------------------------------------------- #
# Batch / cache specs
# ---------------------------------------------------------------------- #
def batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """Train and prefill: ``{"tokens"}`` (and an encoder-decoder's
    ``"src"``); decode: ``{"cache": {flat key: spec}, "token"}`` over the
    cache ``api.cache_init(..., device="meta")`` builds for ``shape``."""
    dax = data_axes(mesh)
    bax = dax if len(dax) > 1 else dax[0]
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec(bax, None)}
        if cfg.is_encoder_decoder:
            specs["src"] = _spec(bax, None, None)
        return specs
    # decode: cache + token
    nd = _axis_size(mesh, dax)
    batch_shardable = shape.global_batch % nd == 0 and shape.global_batch >= nd
    b = bax if batch_shardable else None
    seq = "model" if batch_shardable else ("model", *dax)

    def cache_spec(names, ndim):
        name = _leaf_name(names)
        pre = (None,) if _is_stacked(names) else ()
        if name in ("k", "v"):        # (B, C, Hkv, hd)
            return _spec(*pre, b, seq, None, None)
        if name in ("xk", "xv"):      # cross-attn (B, S_src, Hkv, hd)
            return _spec(*pre, b, None, None, None)
        if name in ("ckv", "kr"):     # MLA (B, C, r)
            return _spec(*pre, b, seq, None)
        if name == "conv":            # (B, K-1, ch)
            return _spec(*pre, b, None, "model")
        if name == "state":           # (B, H, N, P)
            return _spec(*pre, b, "model", None, None)
        if name in ("index", "slot_pos"):
            return () if ndim == 0 else (None,)
        return _spec(*([None] * ndim))

    cache = {}
    for k, leaf in _cache_shape_tree(cfg, shape).items():
        leaf_shape = tuple(getattr(leaf, "shape", ()))    # index: a host int
        cache[k] = _fix(cache_spec(_path_names(k), len(leaf_shape)),
                        leaf_shape, mesh)
    return {"cache": cache, "token": _spec(b, None)}


def _cache_shape_tree(cfg, shape):
    from repro_torch.models import api
    return api.cache_init(cfg, shape.global_batch, shape.seq_len,
                          device="meta")


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` (one spec, or a dict of them, nested)
    as DTensor placements on the ``DeviceMesh`` ``mesh``: for each mesh
    dim, ``Shard(i)`` if its axis occurs in tensor dim i's entry, else
    ``Replicate()``. A dim split over several axes is split in mesh order
    (DTensor's), so an entry naming them in another order (the long-context
    cache's ``("model", "data")``) gives the reference's local shapes with
    the blocks dealt to other ranks. An axis the mesh lacks, or named for
    two dims, raises."""
    if isinstance(spec_tree, Mapping):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    from torch.distributed.tensor import Replicate, Shard
    axes = mesh_shape(mesh).axis_names
    where = {}
    for i, entry in enumerate(spec_tree):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is None:
                continue
            if a not in axes:
                raise ValueError(f"spec {spec_tree} names axis {a!r}, not "
                                 f"one of the mesh's {axes}")
            if a in where:
                raise ValueError(f"spec {spec_tree} names axis {a!r} for "
                                 f"dims {where[a]} and {i}")
            where[a] = i
    return [Shard(where[a]) if a in where else Replicate() for a in axes]
