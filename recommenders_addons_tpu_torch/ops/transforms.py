"""Gradient transformations in optax's shape, written in plain PyTorch.

The JAX package's ``OptaxSparseOptimizer`` applies any optax
``GradientTransformation`` row by row, its state leaves stored as slot
columns. The port cannot import optax, so this module gives the same
vocabulary: ``GradientTransformation(init, update)`` with
``update(updates, state, params) -> (updates, state)``, state NamedTuples
whose field order is optax's (so their leaves flatten in the same order
and become the same slot columns), and the blocks and aliases the JAX
package and its users call: ``chain``, ``identity``, ``scale``,
``scale_by_learning_rate``, ``scale_by_adam``, ``scale_by_rss``,
``trace``, ``adam``, ``adagrad`` and ``sgd``.

Each block computes what optax 0.2.6 computes, operation for operation:
the moments as ``(1 - b) * g + b * t``, the step count's increment
saturating at the int32 maximum, the bias correction ``1 - b ** count``
in float64 (the JAX package runs with 64-bit types enabled, so optax's
``decay ** count`` is a float64 power there) cast to the moment's dtype
before the division, and Adagrad's ``where(sum > 0, rsqrt(sum + eps), 0)``.
Learning rates are numbers; optax's schedules are not ported.

Every function is functional (no in-place operation, no branch on a
tensor's value), so ``torch.func.vmap`` runs it over the rows of a table.
States and updates are pytrees of tensors: a tensor, or a NamedTuple,
tuple, list or dict of pytrees. :func:`tree_flatten` orders their leaves
as ``jax.tree_util`` does (NamedTuple fields in order, dict keys
sorted).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params=None)
    -> (updates, state)``."""

    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    """The state of a stateless transformation."""


class ScaleByAdamState(NamedTuple):
    count: Any  # shape (), int32
    mu: Any
    nu: Any


class ScaleByRssState(NamedTuple):
    sum_of_squares: Any


class TraceState(NamedTuple):
    trace: Any


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree) -> Tuple[List[torch.Tensor], tuple]:
    """``(leaves, treedef)``; the leaves in ``jax.tree_util`` order."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if _is_namedtuple(x):
            return ("namedtuple", type(x), tuple(walk(c) for c in x))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, None, tuple(walk(c) for c in x))
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        leaves.append(x)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: tuple, leaves):
    """The inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        children = [build(c) for c in node[2]]
        if kind == "namedtuple":
            return node[1](*children)
        if kind == "dict":
            return dict(zip(node[1], children))
        return tuple(children) if kind == "tuple" else children

    return build(treedef)


def tree_leaves(tree) -> List[torch.Tensor]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (pytrees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("pytrees of different structure")
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


# ---------------------------------------------------------------------------
# numerics (optax/_src/numerics.py, optax/tree_utils/_tree_math.py)
# ---------------------------------------------------------------------------


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1`` (an integer count), staying at the dtype's maximum
    instead of wrapping."""
    top = torch.iinfo(count.dtype).max
    return torch.where(count < top, count + 1, top)


def bias_correction(moment, decay: float, count: torch.Tensor):
    """``moment / (1 - decay ** count)``: the power and the difference in
    float64, cast to the moment's dtype before the division."""
    base = torch.full((), decay, dtype=torch.float64, device=count.device)
    correction = 1 - torch.pow(base, count.to(torch.float64))
    return tree_map(lambda t: t / correction.to(t.dtype), moment)


# ---------------------------------------------------------------------------
# transformations
# ---------------------------------------------------------------------------


def _init_empty(params):
    del params
    return EmptyState()


def identity() -> GradientTransformation:
    def update_fn(updates, state, params=None):
        del params
        return updates, state

    return GradientTransformation(_init_empty, update_fn)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """The transformations applied in order; the state is their states'
    tuple."""
    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        if len(state) != len(transforms):
            raise ValueError("the chain's state does not match its "
                             "transformations; call init first")
        new_state = []
        for s, t in zip(state, transforms):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def scale(step_size: float) -> GradientTransformation:
    def update_fn(updates, state, params=None):
        del params
        return tree_map(lambda g: step_size * g, updates), state

    return GradientTransformation(_init_empty, update_fn)


def scale_by_learning_rate(learning_rate: float,
                           flip_sign: bool = True) -> GradientTransformation:
    if callable(learning_rate):
        raise TypeError("learning-rate schedules are not ported; pass a "
                        "number")
    return scale((-1 if flip_sign else 1) * learning_rate)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init_fn(params):
        device = tree_leaves(params)[0].device
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def update_fn(updates, state, params=None):
        del params
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates,
                      state.nu)
        count_inc = safe_increment(state.count)
        mu_hat = bias_correction(mu, b1, count_inc)
        nu_hat = bias_correction(nu, b2, count_inc)
        updates = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps),
                           mu_hat, nu_hat)
        return updates, ScaleByAdamState(count=count_inc, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    def init_fn(params):
        return ScaleByRssState(sum_of_squares=tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params))

    def update_fn(updates, state, params=None):
        del params
        sum_of_squares = tree_map(lambda g, t: g * g + t, updates,
                                  state.sum_of_squares)
        inv_sqrt = tree_map(
            lambda t: torch.where(t > 0, torch.rsqrt(t + eps), 0.0),
            sum_of_squares)
        updates = tree_map(lambda s, g: s * g, inv_sqrt, updates)
        return updates, ScaleByRssState(sum_of_squares=sum_of_squares)

    return GradientTransformation(init_fn, update_fn)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init_fn(params):
        return TraceState(trace=tree_map(torch.zeros_like, params))

    def update_fn(updates, state, params=None):
        del params
        f = lambda g, t: g + decay * t  # noqa: E731
        new_trace = tree_map(f, updates, state.trace)
        updates = tree_map(f, updates, new_trace) if nesterov else new_trace
        return updates, TraceState(trace=new_trace)

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# aliases (optax/_src/alias.py)
# ---------------------------------------------------------------------------


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1=b1, b2=b2, eps=eps, eps_root=eps_root),
                 scale_by_learning_rate(learning_rate))


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    return chain(
        scale_by_rss(initial_accumulator_value=initial_accumulator_value,
                     eps=eps),
        scale_by_learning_rate(learning_rate))


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    first = (trace(decay=momentum, nesterov=nesterov)
             if momentum is not None else identity())
    return chain(first, scale_by_learning_rate(learning_rate))
