"""Logical-axis sharding: rules and divisibility-aware resolution, as the
JAX package's ``repro.runtime.sharding``.

Every parameter, cache and input carries a tuple of *logical* axis names
(e.g. ``("vocab", "embed")``). A rule table maps a logical name to mesh
axis tuples in order of preference; the resolver picks the first
candidate whose size divides the dimension and whose mesh axes are still
unused in the spec, else leaves the dimension replicated and records the
downgrade, so the dry run reports how each tensor ended up laid out.

The port has no SPMD partitioner: a spec here is data, a plain tuple with
one entry per dimension, each ``None`` (replicated), a mesh axis name, or
a tuple of names (the reference's ``PartitionSpec`` written out).
:func:`shard_shape` gives a device's local shape under a spec, as
``NamedSharding.shard_shape`` does. The mesh is anything with
``axis_names`` and a ``shape`` mapping names to sizes: a
``transport.SimMesh`` (shape only) or a ``transport.DistMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

#: default rule table. Each logical axis maps to candidates in
#: preference order; () means replicated.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",), ()),
    "seq": ((),),
    "embed": ((),),
    "qkv_features": (("model",), ()),
    "kv_features": (("model",), ()),
    "heads": (("model",), ()),
    "kv_heads": (("model",), ()),
    "head_dim": (("model",), ()),
    "mlp": (("model",), ()),
    "vocab": (("model",), ()),
    "experts": (("data",), ("model",), ()),
    "expert_mlp": (("model",), ()),
    "conv": ((),),
    "ssm_state": ((),),
    "ssm_heads": (("model",), ()),
    "layers": ((),),
    "kv_seq": ((),),
    # sequence-parallel candidates (enabled by perf configs)
    "seq_sp": (("data",), ()),
}


@dataclasses.dataclass
class ResolveReport:
    """Per-tensor record of the chosen spec and any downgrades."""
    chosen: dict[str, tuple] = dataclasses.field(default_factory=dict)
    downgrades: list[str] = dataclasses.field(default_factory=list)


def resolve_spec(shape: Sequence[int], axes: Sequence[str | None], mesh,
                 rules: Mapping[str, tuple] | None = None, name: str = "",
                 report: ResolveReport | None = None) -> tuple:
    """The spec (one entry per dimension) for ``shape`` with logical
    ``axes`` on ``mesh``."""
    rules = rules or DEFAULT_RULES
    mesh_axes = set(mesh.axis_names)
    sizes = mesh.shape
    used: set[str] = set()
    parts: list = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            parts.append(None)
            continue
        placed = None
        for cand in rules.get(ax, ((),)):
            cand = tuple(a for a in cand if a in mesh_axes)
            if not cand:
                break
            size = math.prod(sizes[a] for a in cand)
            if dim % size == 0 and not (set(cand) & used):
                placed = cand
                used |= set(cand)
                break
        if placed:
            parts.append(placed if len(placed) > 1 else placed[0])
            continue
        parts.append(None)
        first = tuple(a for a in rules.get(ax, ((),))[0] if a in mesh_axes)
        if report is not None and first:
            report.downgrades.append(
                f"{name}[{ax}]: {dim} not divisible/available for "
                f"{first} -> replicated")
    spec = tuple(parts)
    if report is not None:
        report.chosen[name] = spec
    return spec


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Sequence) -> set[str]:
    """Every mesh axis a spec shards over."""
    return {a for e in spec for a in entry_axes(e)}


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """A device's local shape of a ``shape`` array laid out by ``spec``
    (missing trailing entries are replicated)."""
    sizes = mesh.shape
    out = []
    for i, dim in enumerate(shape):
        k = math.prod(sizes[a] for a in entry_axes(
            spec[i] if i < len(spec) else None))
        if dim % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} ({dim}) does "
                             f"not divide over {spec[i]} ({k})")
        out.append(dim // k)
    return tuple(out)


def shard_bytes(shape: Sequence[int], itemsize: int, spec: Sequence,
                mesh) -> int:
    """A device's bytes of a ``shape`` array of ``itemsize``-byte elements
    laid out by ``spec``."""
    return math.prod(shard_shape(shape, spec, mesh)) * itemsize


def _walk(tree, is_leaf, path=()):
    """(path, leaf) pairs of nested dicts (sorted keys, as jax flattens a
    dict), named tuples and tuples; a key is written as jax's path keys
    print inside a name (a dict key as it is, a field ``.k``, an index
    ``[0]``)."""
    if is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], is_leaf, path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _walk(v, is_leaf, path + (f".{k}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, is_leaf, path + (f"[{i}]",))
    else:
        yield path, tree


def _rebuild(tree, is_leaf, it):
    if is_leaf(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], is_leaf, it) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, is_leaf, it) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, is_leaf, it) for v in tree)
    return next(it)


def flatten_with_path(tree, is_leaf=lambda x: False) -> list:
    """[(name, leaf)] in jax's flattening order, each name the path's keys
    joined by ``/`` (the reference's names in reports)."""
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in _walk(tree, is_leaf)]


def unflatten_like(tree, leaves_, is_leaf=lambda x: False):
    """``tree``'s structure with ``leaves_`` in flattening order."""
    return _rebuild(tree, is_leaf, iter(leaves_))


def _has_axes(x) -> bool:
    return hasattr(x, "axes") and hasattr(x, "shape")


def tree_shardings(spec_tree, mesh, rules=None,
                   report: ResolveReport | None = None):
    """A tree of ParamSpec-likes (``.shape`` / ``.axes``) -> the same tree
    of specs."""
    out = [resolve_spec(leaf.shape, leaf.axes, mesh, rules, name, report)
           for name, leaf in flatten_with_path(spec_tree, _has_axes)]
    return unflatten_like(spec_tree, out, _has_axes)
