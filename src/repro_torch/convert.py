"""Carry parameter dicts between numpy arrays and the port's tensors.

The parity tests take the JAX package's parameters as numpy arrays
(``np.asarray`` of each leaf) into the port with ``params_from_numpy`` and
bring the port's back with ``params_to_numpy``; keys, shapes and dtypes are
kept.

The JAX package's LM parameters are a nested tree of dicts and tuples;
the port's are one flat dict keyed by the "/"-joined tree paths
(``blocks/layers/0/mixer/wq``, ``embed``, a MoE layer's
``blocks/layers/1/mlp/router`` and ``.../mlp/shared/wg``, ...). ``flatten_tree`` and
``unflatten_tree`` convert between the two. The sorted order of the flat
keys is the JAX package's leaf order (dict keys sorted, tuple items in
order) for keys of letters, digits and underscores and tuples of at most
10 items, as the LM's are, so ``aggregation.flatten_stacked`` lays the
updates out in the reference's column order.

A decode cache crosses the same way: ``cache_from_numpy`` takes the JAX
package's cache tree (``blocks``, an empty ``head_layers``, a traced
``index``, ``slot_pos`` for a ring) as numpy leaves into the port's flat
cache (``index`` a host int), and ``cache_to_numpy`` gives the port's back
as that tree, so either package can decode from the other's cache — a
hybrid's too, whose layers hold attention k/v and SSM conv/state caches
side by side.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def params_to_numpy(p: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in p.items()}


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested tree of dicts and tuples -> {"/"-joined path: leaf}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: Mapping[str, Any]):
    """The inverse of ``flatten_tree``: a level whose keys are all
    integers becomes a tuple in index order."""
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(build(node[k]) for k in sorted(node, key=int))
        return {k: build(v) for k, v in node.items()}

    return build(root)


def cache_from_numpy(tree, device) -> Dict[str, Any]:
    """The JAX package's decode cache (numpy leaves) -> the port's flat
    cache on ``device``."""
    flat = flatten_tree(tree)
    out: Dict[str, Any] = {"index": int(flat.pop("index"))}
    out.update(params_from_numpy(flat, device))
    return out


def cache_to_numpy(cache: Mapping[str, Any]):
    """The port's flat cache -> the JAX package's cache tree, numpy
    leaves (``index`` int32, as the reference traces it)."""
    flat = {k: v for k, v in cache.items() if k != "index"}
    tree = unflatten_tree(params_to_numpy(flat))
    tree["index"] = np.asarray(cache["index"], np.int32)
    tree["head_layers"] = ()
    return tree
