"""Parameter schema: shape + dtype + logical axes + init.

Models declare a nested dict of :class:`ParamSpec`; from it come
``init_params`` (tensors drawn from a seeded ``torch.Generator``),
:func:`abstract_params` (fake tensors: shapes and dtypes, no storage, for
the shape-only dry run), ``count_params``, and :func:`from_reference`,
which carries the JAX package's parameters (as numpy arrays) across. The
logical axes resolve to a mesh layout through
``repro_torch.runtime.sharding.tree_shardings``, which the dry run
(``launch/dryrun.py``) prices per device; the training and serving paths
hold every parameter whole on their device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"        # normal | zeros | ones | small_normal
    scale: float | None = None  # overrides the fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def spec(shape: Sequence[int], axes: Sequence[str | None],
         dtype: torch.dtype = torch.float32, init: str = "normal",
         scale: float | None = None) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def abstract_params(spec_tree, mode=None, device="cpu"):
    """Fake tensors of every spec's shape and dtype on ``device``, in
    :func:`map_tree`'s sorted order: created under ``mode`` (a
    ``torch._subclasses.fake_tensor.FakeTensorMode``; a new one when
    None), so nothing is allocated and the step they enter must run under
    the same mode."""
    if mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
    with mode:
        return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device=device), spec_tree)


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, in sorted key order (the
    order jax flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


def init_params(generator: torch.Generator, spec_tree):
    """Tensors for every spec, on the generator's device: zeros, ones, or
    float32 normals times the fan-in scale (0.02 for ``small_normal``)
    cast to the spec's dtype. The scale multiplies the draw in place, the
    same float32 product as ``x * scale``, so a leaf never holds more
    than one float32 copy beside its cast (kimi-k2's 10.5 GiB bf16 expert
    stacks would otherwise need two 21 GiB float32 temporaries each)."""
    device = generator.device

    def draw(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.scale if s.scale is not None else fan_in ** -0.5
        if s.init == "small_normal":
            scale = s.scale if s.scale is not None else 0.02
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(s.dtype)

    return map_tree(draw, spec_tree)


def count_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for s in leaves(spec_tree))


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":  # ml_dtypes: move the bits across
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_tree(tree, spec_tree, device=None):
    """Numpy arrays shaped like ``spec_tree`` -> tensors of the specs'
    dtypes on ``device`` (CUDA unless given; raises without it)."""
    device = resolve_device(device)

    def load(s, a):
        if isinstance(s, ParamSpec):
            if tuple(np.shape(a)) != s.shape:
                raise ValueError(f"parameter of shape {np.shape(a)}, the "
                                 f"schema says {s.shape}")
            return _tensor(a).to(device=device, dtype=s.dtype)
        keys = sorted(a) if isinstance(a, dict) else type(a).__name__
        if keys != sorted(s):
            raise ValueError(f"parameter keys {keys} differ from the "
                             f"schema's {sorted(s)}")
        return {k: load(s[k], a[k]) for k in sorted(s)}

    return load(spec_tree, tree)


def from_reference(tree, cfg, device=None):
    """The JAX package's parameter tree for ``cfg``, as numpy arrays
    (``jax.tree.map(np.asarray, M.init(key, cfg))``) -> the port's
    parameters: the same nested dict, layers stacked on axis 0, each leaf
    in its spec's dtype (so a bfloat16 mamba model keeps its float32
    ``a_log``, ``dt_bias`` and ``d_skip``), on ``device``."""
    from repro_torch.models import model  # model imports this module
    return load_tree(tree, model.param_specs(cfg), device)
