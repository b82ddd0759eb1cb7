"""Parameter specs: one source of truth for shapes, dtypes and init.

A model is described by a *spec tree* — a nested dict whose leaves are
:class:`ParamSpec` (shape, logical axis names, initializer, dtype). From
it the port derives the parameters (:func:`init_params`) and their exact
count (:func:`param_count`, no allocation). The initializers and their
standard deviations are the reference's; the random numbers are not
(``torch.Generator`` is not ``jax.random``), so parity tests carry the
reference's parameters over instead.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/init/logical-axes of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones | embed | small
    scale: float | None = None            # stddev override for 'normal'
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _fan_in(shape: tuple[int, ...]) -> int:
    return shape[0] if len(shape) >= 2 else max(shape[-1], 1)


def init_std(spec: ParamSpec) -> float:
    """The standard deviation of a random leaf, as the reference draws it:
    0.02 for 'embed' and 'small', else 1/√fan_in (fan-in = the leading
    dim of a ≥ 2-D shape; of a stacked spec that is the layer count)."""
    if spec.scale is not None:
        return spec.scale
    if spec.init in ("embed", "small"):
        return 0.02
    return 1.0 / math.sqrt(_fan_in(spec.shape))


def leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict in sorted-key order, the
    reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _init_leaf(spec: ParamSpec, generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * init_std(spec)).to(spec.dtype)


def init_params(spec_tree, generator: torch.Generator | None = None,
                device=None):
    """Materialize a spec tree on ``device``, drawing the random leaves
    from ``generator`` (which must live on that device) in sorted-key
    order."""
    vals = {path: _init_leaf(s, generator, device)
            for path, s in leaves(spec_tree)}
    return _unflatten(spec_tree, vals)


def _unflatten(tree, vals, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, vals, prefix + (k,)) for k, v in tree.items()}
    return vals[prefix]


def param_count(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in leaves(spec_tree)))


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Stack a per-layer spec tree n× along a new leading 'layers' axis."""
    return map_tree(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes), spec_tree)


def unstack(tree, n: int) -> list:
    """A tree of stacked ``(n, ...)`` leaves as ``n`` per-layer trees (views)."""
    return [map_tree(lambda t: t[i], tree) for i in range(n)]


class TreeNode(torch.nn.Module):
    """A node of a parameter tree that holds tensors beside subtrees (a
    Hymba layer: ``beta_attn`` next to ``attn``), indexed by name like a
    dict."""

    def __init__(self, tree: dict, *, requires_grad: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, torch.nn.Parameter(v, requires_grad=requires_grad))
            else:
                self.add_module(k, as_module(v, requires_grad=requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self) -> list:
        return list(self._parameters) + list(self._modules)

    def items(self) -> list:
        return [(k, self[k]) for k in self.keys()]


def as_module(tree, *, requires_grad: bool = False) -> torch.nn.Module:
    """A nested dict (and list) of tensors as ``nn.ModuleDict`` /
    ``nn.ModuleList`` of ``nn.ParameterDict`` leaves (a :class:`TreeNode`
    where a node holds both), so that a model owns its parameters and
    indexes them as the reference indexes its tree. Served models freeze
    their parameters; trained ones pass ``requires_grad=True``."""
    if isinstance(tree, list):
        return torch.nn.ModuleList([as_module(t, requires_grad=requires_grad)
                                    for t in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return torch.nn.ParameterDict({
            k: torch.nn.Parameter(v, requires_grad=requires_grad)
            for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return TreeNode(tree, requires_grad=requires_grad)
    return torch.nn.ModuleDict({k: as_module(v, requires_grad=requires_grad)
                                for k, v in tree.items()})


def module_leaves(module, prefix=()):
    """``(path, parameter)`` pairs of an :func:`as_module` tree in sorted-key
    order (list entries by index): a fixed order for optimizer state and
    gradients."""
    if isinstance(module, torch.nn.Parameter):
        yield prefix, module
    elif isinstance(module, torch.nn.ParameterDict):
        for k in sorted(module.keys()):
            yield prefix + (k,), module[k]
    elif isinstance(module, torch.nn.ModuleList):
        for i, m in enumerate(module):
            yield from module_leaves(m, prefix + (i,))
    else:
        for k in sorted(module.keys()):
            yield from module_leaves(module[k], prefix + (k,))
