"""Sparse row-wise optimizers for dynamic-embedding tables — the port of
the JAX package's ``ops/optimizer.py`` (named optimizers and the apply).

Optimizer slots are extra columns of the table's packed rows
(``TableState.slots``); a step is lookup -> row-wise optimizer math ->
one planned write of rows, slots and scores. The named optimizers keep
the JAX package's slot names and update math, operation for operation.

The apply has two paths, chosen from dtype and shape only (the same on
every device):

* fused (every named optimizer on an f32 table, or a bf16 table of even
  dim, whose slots existed at lookup): the optimizer runs inside the
  ``fused_update_scatter`` kernel, which reads the lookup's packed rows
  and writes the new rows straight into the table (``ops/cuda_ops.py``);
* unfused (f16, f64 and int8 tables, every ``bp_v2`` table, and the
  optax-style adapter): ``update`` on the looked-up rows in their own
  dtype (f64 end to end: the grad combine, the slots and the
  hyper-parameters), then ``Variable.writeback`` (the row-scatter kernel,
  on the 64-bit view for an f64 table).

A deferred-dedup lookup's duplicates are combined here, and
``return_evicted=True`` returns the rows the apply's inserts displace.

``OptaxSparseOptimizer`` applies any ``ops.transforms``
``GradientTransformation`` (the port's optax-shaped transforms) row by
row, as the JAX package's adapter applies an optax one: the state leaves
are slot columns ``optax_0``, ``optax_1``, ..., and scalar leaves (a step
count) advance per row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from recommenders_addons_tpu_torch.ops import cuda_ops, hashtable, transforms


class SparseOptimizer:
    """Row-wise optimizer protocol: ``slot_specs()`` -> {slot name: fresh
    fill}; ``update(rows, grads, slots, step)`` -> (new rows, new slots),
    all ``[U, D]``; ``fused_rule()`` -> what the fused kernel applies."""

    def slot_specs(self) -> Dict[str, float]:
        raise NotImplementedError

    def update(self, rows, grads, slots, step):
        raise NotImplementedError

    def _kernel_args(self) -> Tuple[str, tuple, tuple]:
        """(kernel rule name, hyper-parameters in its order, its slots in
        its order)."""
        raise NotImplementedError

    def fused_rule(self) -> cuda_ops.FusedRule:
        kind, hparams, slots = self._kernel_args()
        return cuda_ops.FusedRule(kind=kind, hparams=hparams, slots=slots,
                                  update=self.update)


@dataclasses.dataclass(frozen=True, eq=False)
class SGD(SparseOptimizer):
    learning_rate: float = 0.01

    def slot_specs(self):
        return {}

    def update(self, rows, grads, slots, step):
        return rows - self.learning_rate * grads, {}

    def _kernel_args(self):
        return "sgd", (self.learning_rate,), ()


@dataclasses.dataclass(frozen=True, eq=False)
class Momentum(SparseOptimizer):
    learning_rate: float = 0.01
    momentum: float = 0.9
    nesterov: bool = False

    def slot_specs(self):
        return {"momentum": 0.0}

    def update(self, rows, grads, slots, step):
        m = slots["momentum"] * self.momentum + grads
        upd = grads + self.momentum * m if self.nesterov else m
        return rows - self.learning_rate * upd, {"momentum": m}

    def _kernel_args(self):
        return ("momentum", (self.learning_rate, self.momentum,
                             1.0 if self.nesterov else 0.0), ("momentum",))


@dataclasses.dataclass(frozen=True, eq=False)
class Adagrad(SparseOptimizer):
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    epsilon: float = 1e-7

    def slot_specs(self):
        return {"accumulator": self.initial_accumulator_value}

    def update(self, rows, grads, slots, step):
        acc = slots["accumulator"] + grads * grads
        new = rows - self.learning_rate * grads / (
            torch.sqrt(acc) + self.epsilon)
        return new, {"accumulator": acc}

    def _kernel_args(self):
        return ("adagrad", (self.learning_rate, self.epsilon),
                ("accumulator",))


@dataclasses.dataclass(frozen=True, eq=False)
class Adam(SparseOptimizer):
    learning_rate: float = 0.001
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7

    def slot_specs(self):
        return {"m": 0.0, "v": 0.0}

    def update(self, rows, grads, slots, step):
        t = torch.as_tensor(step, dtype=rows.dtype, device=rows.device) + 1.0
        m = self.beta_1 * slots["m"] + (1.0 - self.beta_1) * grads
        v = self.beta_2 * slots["v"] + (1.0 - self.beta_2) * grads * grads
        lr_t = (self.learning_rate * torch.sqrt(1.0 - self.beta_2 ** t)
                / (1.0 - self.beta_1 ** t))
        new = rows - lr_t * m / (torch.sqrt(v) + self.epsilon)
        return new, {"m": m, "v": v}

    def _kernel_args(self):
        return ("adam", (self.learning_rate, self.beta_1, self.beta_2,
                         self.epsilon, 1.0 - self.beta_1, 1.0 - self.beta_2),
                ("m", "v"))


@dataclasses.dataclass(frozen=True, eq=False)
class AdamW(Adam):
    weight_decay: float = 0.004

    def update(self, rows, grads, slots, step):
        new, s = super().update(rows, grads, slots, step)
        return new - self.learning_rate * self.weight_decay * rows, s

    def _kernel_args(self):
        _, hparams, slots = super()._kernel_args()
        return ("adamw", hparams + (self.learning_rate * self.weight_decay,),
                slots)


@dataclasses.dataclass(frozen=True, eq=False)
class RMSprop(SparseOptimizer):
    learning_rate: float = 0.001
    rho: float = 0.9
    momentum: float = 0.0
    epsilon: float = 1e-7

    def slot_specs(self):
        return {"rms": 0.0, "momentum": 0.0}

    def update(self, rows, grads, slots, step):
        rms = self.rho * slots["rms"] + (1.0 - self.rho) * grads * grads
        mom = (self.momentum * slots["momentum"]
               + self.learning_rate * grads / torch.sqrt(rms + self.epsilon))
        return rows - mom, {"rms": rms, "momentum": mom}

    def _kernel_args(self):
        return ("rmsprop", (self.learning_rate, self.rho, self.momentum,
                            self.epsilon, 1.0 - self.rho), ("rms", "momentum"))


@dataclasses.dataclass(frozen=True, eq=False)
class FTRL(SparseOptimizer):
    learning_rate: float = 0.001
    learning_rate_power: float = -0.5
    initial_accumulator_value: float = 0.1
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0

    def slot_specs(self):
        return {"accumulator": self.initial_accumulator_value,
                "linear": 0.0}

    def update(self, rows, grads, slots, step):
        n, z = slots["accumulator"], slots["linear"]
        p = self.learning_rate_power
        # a divisor on the rows' device: PyTorch's CUDA division by a
        # Python or CPU scalar multiplies by its reciprocal, which rounds
        # differently
        lr = rows.new_full((), self.learning_rate)
        n_new = n + grads * grads
        sigma = (n_new ** -p - n ** -p) / lr
        z_new = z + grads - sigma * rows
        l1 = self.l1_regularization_strength
        l2 = self.l2_regularization_strength
        quad = n_new ** -p / lr + 2.0 * l2
        pruned = torch.clamp(z_new, -l1, l1) - z_new
        new = torch.where(z_new.abs() > l1, pruned / quad, 0.0)
        return new, {"accumulator": n_new, "linear": z_new}

    def _kernel_args(self):
        return ("ftrl", (self.learning_rate, -self.learning_rate_power,
                         self.l1_regularization_strength,
                         2.0 * self.l2_regularization_strength),
                ("accumulator", "linear"))


_NAMED = {"sgd": SGD, "momentum": Momentum, "adagrad": Adagrad,
          "adam": Adam, "adamw": AdamW, "rmsprop": RMSprop, "ftrl": FTRL}


class OptaxSparseOptimizer(SparseOptimizer):
    """Adapter: any ``transforms.GradientTransformation`` applied row-wise.

    The state leaves of ``tx.init(zeros[dim])`` (in ``jax.tree_util``
    order) become slot columns ``optax_<i>`` whose fill is the leaf's
    first element. Scalar leaves (e.g. Adam's int32 step count) are
    stored broadcast across a ``[C, dim]`` column in the table's dtype,
    read back as ``col[:, 0]`` cast to the leaf's dtype, and advance per
    row: each row's bias correction tracks its own update count. The
    update runs ``tx.update`` on one row under ``torch.func.vmap``.
    Transforms that couple parameters globally see one row as the whole
    tree. Never fused: the apply takes the unfused path (row gather,
    update, row scatter)."""

    def __init__(self, tx, dim: int, dtype=torch.float32):
        self._tx = tx
        probe = tx.init(torch.zeros((dim,), dtype=dtype))
        leaves, self._treedef = transforms.tree_flatten(probe)
        self._leaf_shapes = [tuple(leaf.shape) for leaf in leaves]
        self._leaf_dtypes = [leaf.dtype for leaf in leaves]
        self._names = [f"optax_{i}" for i in range(len(leaves))]
        self._fills = [float(leaf.reshape(-1)[0]) for leaf in leaves]

    def slot_specs(self):
        return dict(zip(self._names, self._fills))

    def _state_from_slots(self, slots):
        leaves = []
        for name, shape, dt in zip(self._names, self._leaf_shapes,
                                   self._leaf_dtypes):
            col = slots[name]  # [U, D]
            leaves.append(col[:, 0].to(dt) if shape == () else col.to(dt))
        return leaves

    def update(self, rows, grads, slots, step):
        del step  # scalar leaves carry the per-row count
        leaves = self._state_from_slots(slots)
        treedef, tx = self._treedef, self._tx

        def row_update(g, p, *state_leaves):
            st = transforms.tree_unflatten(treedef, state_leaves)
            upd, new_st = tx.update(g, st, p)
            return (p + upd, *transforms.tree_leaves(new_st))

        new_rows, *new_leaves = torch.func.vmap(row_update)(grads, rows,
                                                            *leaves)
        new_slots = {}
        for name, shape, leaf in zip(self._names, self._leaf_shapes,
                                     new_leaves):
            if shape == ():
                leaf = leaf[:, None].expand(rows.shape).to(rows.dtype)
            new_slots[name] = leaf
        return new_rows, new_slots


def DynamicEmbeddingOptimizer(opt, bp_v2=None, **_kw):
    """Parity entry point: a ``SparseOptimizer`` is returned unchanged, a
    name string gives that named optimizer with its defaults, and
    anything else (a ``transforms.GradientTransformation``) is wrapped
    lazily per table (:func:`resolve_for`). ``bp_v2`` lives on the
    ``Variable``; the keyword is accepted and ignored."""
    del bp_v2
    if isinstance(opt, (SparseOptimizer, _LazyOptax)):
        return opt
    if isinstance(opt, str):
        return _NAMED[opt.lower()]()
    return _LazyOptax(opt)


class _LazyOptax:
    """Defers the optax-style wrapping until the table's dim is known."""

    def __init__(self, tx):
        self.tx = tx
        self._cache: Dict[Tuple[int, Any], OptaxSparseOptimizer] = {}

    def resolve(self, dim: int, dtype) -> OptaxSparseOptimizer:
        k = (dim, dtype)
        if k not in self._cache:
            self._cache[k] = OptaxSparseOptimizer(self.tx, dim, dtype)
        return self._cache[k]


def resolve_for(opt, var) -> SparseOptimizer:
    """The row-wise optimizer for ``var``: a lazy optax-style wrapper (or
    a bare transform) resolved by the table's dim and value dtype."""
    opt = DynamicEmbeddingOptimizer(opt)
    if isinstance(opt, _LazyOptax):
        return opt.resolve(var.dim, var.value_dtype)
    return opt


def create_slots(var, state: hashtable.TableState,
                 opt) -> hashtable.TableState:
    """Ensure the optimizer's slot columns exist (on every shard of a
    sharded table's state)."""
    if hasattr(state, "shards"):
        return state.replace(create_slots(var, st, opt)
                             for st in state.shards)
    for name, fill in resolve_for(opt, var).slot_specs().items():
        state = hashtable.with_slot(state, name, fill)
    return state


def gather_slot_rows(var, state, ctx, opt) -> Dict[str, torch.Tensor]:
    """Slot rows for the looked-up keys (misses get the fresh fill), from
    the lookup's packed rows when their width is the table's, else one
    re-gather (the first step after a slot column appeared)."""
    specs = opt.slot_specs()
    if not specs:
        return {}
    n = ctx.slot.shape[0]
    packed = ctx.packed
    if packed is not None:
        packed = hashtable.packed_logical_view(state, n, packed)
    if packed is None or packed.shape[1] != state.width:
        packed = hashtable.gather_packed(state, ctx.slot, ctx.found)
    d = state.dim
    out = {}
    for name, fill in specs.items():
        off = state.slot_offset(name)
        col = packed[:, off:off + d]
        # the fill made on the device (a host tensor would be copied
        # there: a host sync per slot)
        out[name] = torch.where(ctx.found[:, None], col, col.new_full((),
                                                                      fill))
    return out


def apply_gradients(var, state: hashtable.TableState, ctx, grads, opt,
                    step=0, epoch=0, already_unique: bool = False,
                    return_evicted: bool = False):
    """Sparse apply: combine duplicate grads, run the row-wise optimizer,
    write rows, slots and scores. ``grads`` is the gradient of the
    ``emb`` output of ``embedding_lookup`` (any shape ending in ``dim``),
    or ``[U, dim]`` per unique row with ``already_unique=True``. The table
    rows are written in place (the fused kernel, or the row scatter).
    ``return_evicted``: returns ``(state, evicted)``, the rows displaced
    by this apply's inserts (keys, values, scores, slots) and the keys
    that could not be placed, so a spill tier loses no row."""
    opt = resolve_for(opt, var)
    if not already_unique:
        if ctx.deferred:
            # combine duplicate grads AND narrow the write mask to one
            # representative per row; what follows takes the new ctx
            grads, found_rep = var.reduce_gradient_deferred(ctx, grads)
            ctx = dataclasses.replace(ctx, found=found_rep)
        else:
            grads = var.reduce_gradient(ctx, grads)
    state = create_slots(var, state, opt)
    if _can_fuse(var, state, ctx, opt):
        # padding rows (EMPTY keys) are neither found nor inserted: the
        # kernel writes their update to the trash row, so their grads
        # need no masking. The kernel writes the table in place, so the
        # victims are read before it runs.
        evicted = (_capture_evicted(var, state, ctx) if return_evicted
                   else None)
        new_state = _apply_fused(var, state, ctx, grads, opt, step, epoch)
        return (new_state, evicted) if return_evicted else new_state
    valid = ctx.unique_keys != var.empty_key
    grads = torch.where(valid[:, None], grads, 0.0)
    slot_rows = gather_slot_rows(var, state, ctx, opt)
    new_rows, new_slot_rows = opt.update(ctx.rows, grads.to(ctx.rows.dtype),
                                         slot_rows, step)
    return var.writeback(state, ctx, new_rows, slot_rows=new_slot_rows,
                         step=step, epoch=epoch,
                         return_evicted=return_evicted)


def _capture_evicted(var, state, ctx):
    """The rows this apply's planned inserts displace, read from the
    table before the fused kernel writes it: the victims' keys from the
    key planes the apply starts from (``state``'s, not the lookup's
    ``ctx.key_lo``/``key_hi``, which carry the new keys), their rows
    gathered fresh (``ctx.packed`` holds the new keys' initial rows
    there). Keys dropped for a full bucket keep their looked-up row."""
    d = var.dim
    old_keys = hashtable.join_key(
        hashtable.take_elem(state.key_lo, ctx.slot),
        hashtable.take_elem(state.key_hi, ctx.slot)).to(var.key_dtype)
    displaced = ctx.inserted & (old_keys != var.empty_key)
    victim = hashtable.gather_packed(state, ctx.slot, displaced)
    return {
        "keys": torch.where(displaced, old_keys, var.empty_key),
        "values": torch.where(displaced[:, None], victim[:, :d], 0),
        "scores": torch.where(
            displaced, hashtable.take_elem(state.scores, ctx.slot), 0),
        "slots": {nm: torch.where(
            displaced[:, None],
            victim[:, state.slot_offset(nm):state.slot_offset(nm) + d], 0)
            for nm in state.slot_names},
        "dropped_keys": torch.where(ctx.dropped, ctx.unique_keys,
                                    var.empty_key),
        "dropped_values": torch.where(
            ctx.dropped[:, None], ctx.rows.to(state.value_dtype), 0),
    }


def _can_fuse(var, state, ctx, opt) -> bool:
    """Whether the fused kernel takes this apply: a named optimizer, an
    f32 table or a bf16 table of even dim, the plan captured at lookup,
    and a packed block as wide as the table (its slots existed then)."""
    if not isinstance(opt, tuple(_NAMED.values())):
        return False
    pf = hashtable._pack_factor(state.value_dtype)
    container_ok = (
        (pf == 1 and state.value_dtype == torch.float32)
        or (pf == 2 and var.dim % 2 == 0
            and state.value_dtype == torch.bfloat16))
    if (var.bp_v2 or ctx.inserted is None or ctx.packed is None
            or not container_ok
            or not set(opt.slot_specs()) <= set(state.slot_names)):
        return False
    n = ctx.slot.shape[0]
    return (ctx.packed.shape[1] == state.width
            or hashtable.packed_is_phys(state, n, ctx.packed))


def _apply_fused(var, state, ctx, grads, opt, step, epoch):
    """The optimizer fused into the row scatter. The kernel reads the
    lookup's packed rows (value columns = the blended rows, inserted rows'
    slot columns = fresh fills: the ``plan_lookup_train`` invariants) and
    writes ``state.rows`` in place; ``ctx.packed`` is the lookup's own
    buffer, never a view of the table."""
    pf = hashtable._pack_factor(state.value_dtype)
    n = ctx.slot.shape[0]
    wc = state.chunks * hashtable._LANES  # container words per row
    if hashtable.packed_is_phys(state, n, ctx.packed):
        words = ctx.packed.reshape(n, wc)
    else:
        words = ctx.packed.contiguous().view(state.rows.dtype)
    idx = torch.where(ctx.found | ctx.inserted, ctx.slot, state.capacity)
    cuda_ops.fused_update_scatter(
        state.rows, state.chunks, idx, words, grads.to(torch.float32),
        opt.fused_rule(), dim=var.dim, slot_names=state.slot_names,
        cap=state.capacity, step=float(step), pf=pf)
    plan = (ctx.slot, ctx.found, ctx.inserted, ctx.dropped)
    if ctx.scores is not None and ctx.key_lo is not None:
        # the lookup committed this batch's inserted keys and scores
        return state.replace(key_lo=ctx.key_lo, key_hi=ctx.key_hi,
                             scores=ctx.scores)
    scores, mode = var.scores_for(ctx.unique_keys, step=step, epoch=epoch)
    if ctx.key_lo is not None:
        return hashtable.commit_scores(
            var.spec, state.replace(key_lo=ctx.key_lo, key_hi=ctx.key_hi),
            plan, scores, score_mode=mode)
    return hashtable.commit_keys_scores(var.spec, state, ctx.unique_keys,
                                        plan, scores=scores, score_mode=mode)
