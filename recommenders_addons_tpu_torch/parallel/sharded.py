"""Sharded dynamic-embedding tables: all-to-all routed lookup and apply —
the port of the JAX package's ``parallel/sharded.py``.

It stands for both of the reference's sharding mechanisms: the
intra-process ``Variable(devices=[...])`` (DynamicPartition /
DynamicStitch) and the inter-process ``HvdAllToAllEmbedding``. A
``ShardedVariable`` binds a ``Variable`` to a mesh (``parallel/mesh.py``):
S shards, each a one-table ``TableState`` of capacity
``max(capacity // S, bucket_size)`` on its device, together a
:class:`ShardedState`. A step:

    1. every source shard takes its block of the batch (the padded global
       batch split into S contiguous blocks, as ``shard_map`` splits
       ``P(axis)``; on a process group, the rank's own batch) and routes
       each key to its owner, ``hashing.shard_of``, into fixed-size
       buffers of K keys per (source, destination) pair;
    2. the buffers ride the exchange's ``all_to_all``;
    3. each owner runs the one-table ``plan_lookup_train`` over what it
       received (the row gather, kernel 1);
    4. the rows ride the inverse exchange back;
    5. the gradients take the same route, and each owner applies them
       with the fused optimizer-scatter (kernel 3).

``K = ceil(capacity_factor * U / S)`` rounded up to 8. A key that does
not fit reads its deterministic initial row and skips the step's update,
counted in ``ctx.num_dropped``; a batch whose duplicates of one key
overflow a buffer retries through a batch-side dedup (``ctx.deduped``).

The exchange is the only code that differs between an in-process mesh
and a process group; everything else runs once for each shard this
process holds. Where the JAX package branches with ``lax.cond`` the port
branches in Python on a value read back from the device (a host sync),
each marked ``# host sync``; ``ShardedVariable.stats["host_syncs"]``
counts the routing's own (the owners' plans add theirs).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashing, hashtable, initializers
from recommenders_addons_tpu_torch.ops import optimizer as opt_lib
from recommenders_addons_tpu_torch.ops.variable import LookupContext, Variable
from recommenders_addons_tpu_torch.parallel.mesh import GroupMesh, Mesh


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class ShardedState:
    """The state of a sharded table: one ``TableState`` for each shard this
    process holds (all S on a ``Mesh``, the rank's own on a
    ``GroupMesh``), ``shard_ids`` their indices."""

    shards: List[hashtable.TableState]
    shard_ids: Tuple[int, ...]
    num_shards: int

    @property
    def slot_names(self) -> tuple:
        return self.shards[0].slot_names

    @property
    def slot_inits(self) -> tuple:
        return self.shards[0].slot_inits

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def stacked(self, name: str) -> torch.Tensor:
        """``[shards, ...]`` of one field or property of every shard (on
        the first shard's device)."""
        return torch.stack([getattr(st, name).to(self.device)
                            for st in self.shards])

    @property
    def keys(self) -> torch.Tensor:
        return self.stacked("keys")

    @property
    def scores(self) -> torch.Tensor:
        return self.stacked("scores")

    @property
    def values(self) -> torch.Tensor:
        return self.stacked("values")

    def replace(self, shards) -> "ShardedState":
        return dataclasses.replace(self, shards=list(shards))


@dataclasses.dataclass
class ShardedLookupContext:
    """Routing residuals of a training lookup, one entry for each shard
    this process holds, and each owner's ``LookupContext`` over its
    received ``[S*K]`` buffer, which the apply re-uses (no second probe).
    ``deduped``: the lookup took the dedup retry (hot-key overflow):
    occurrences of one key then share a buffer slot and the grads'
    route back sums them."""

    send_pos: List[torch.Tensor]  # [n] position in the [S*K] buffer
    routed: List[torch.Tensor]  # [n] bool: made it into the buffer
    num_dropped: List[torch.Tensor]  # [] int32 overflowed keys
    deduped: bool
    octx: List[LookupContext]  # the owner's plan over its recv buffer


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedVariable:
    """A ``Variable`` bound to one or more axes of a mesh (the reference's
    ``Variable(devices=[...])`` and ``HvdAllToAllEmbedding``). A tuple of
    axes (``("dp", "ep")``) shards over their flattened product."""

    var: Variable
    mesh: Any
    axis: Any = "ep"
    capacity_factor: float = 2.0

    def __post_init__(self):
        if not isinstance(self.mesh, (Mesh, GroupMesh)):
            raise TypeError(
                f"mesh must be a parallel.Mesh or parallel.GroupMesh, not "
                f"{type(self.mesh).__name__}")
        if isinstance(self.axis, (list, tuple)):
            object.__setattr__(self, "axis", tuple(self.axis))
        s = self.num_shards
        if self.var.num_shards != s:
            object.__setattr__(self, "var", dataclasses.replace(
                self.var, num_shards=s, devices=None))
        self._local  # checks the axes

    @property
    def axes(self) -> tuple:
        return self.axis if isinstance(self.axis, tuple) else (self.axis,)

    @property
    def num_shards(self) -> int:
        n = 1
        for a in self.axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def spec(self):
        return self.var.spec

    @functools.cached_property
    def _local(self) -> List[Tuple[int, torch.device]]:
        """``(shard index, device)`` of every shard this process holds."""
        return self.mesh.shard_devices(self.axes)

    @functools.cached_property
    def _x(self):
        return self.mesh.exchange(self.axes)

    @functools.cached_property
    def stats(self) -> dict:
        """``host_syncs``: the routing's host syncs so far (the owners'
        plans add their own; see the module docstring)."""
        return {"host_syncs": 0}

    @property
    def in_process(self) -> bool:
        return isinstance(self.mesh, Mesh)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init(self) -> ShardedState:
        """Empty shards, each on its mesh device."""
        return ShardedState(
            shards=[hashtable.create(self.spec, dev)
                    for _, dev in self._local],
            shard_ids=tuple(i for i, _ in self._local),
            num_shards=self.num_shards)

    def create_slots(self, state: ShardedState, optimizer) -> ShardedState:
        """Add the optimizer's missing slot columns to every shard."""
        opt = opt_lib.resolve_for(optimizer, self.var)
        return self.ensure_slot_columns(state, opt.slot_specs())

    def ensure_slot_columns(self, state: ShardedState,
                            specs: Dict[str, float]) -> ShardedState:
        """Add missing slot columns by name -> fresh fill value."""
        missing = {k: v for k, v in specs.items()
                   if k not in state.slot_names}
        if not missing:
            return state
        shards = []
        for st in state.shards:
            for name, fill in missing.items():
                st = hashtable.with_slot(st, name, fill)
            shards.append(st)
        return state.replace(shards)

    def _k_per_pair(self, num_unique: int, worst_case: bool = False) -> int:
        """Per-(source, destination) buffer capacity: ``ceil(
        capacity_factor * U / S)`` (float64) rounded up to 8; the whole
        ``U`` for the bulk writes (``worst_case``), where a dropped key
        would be lost data."""
        if worst_case:
            return max(8, _round_up(num_unique, 8))
        s = self.num_shards
        k = int(np.ceil(self.capacity_factor * num_unique / s))
        return max(8, _round_up(min(k, num_unique), 8))

    def _split(self, x, fill) -> Tuple[List[torch.Tensor], int]:
        """The blocks of ``x`` (axis 0) this process's shards take, each on
        its shard's device, and ``x``'s length. In process: ``x`` padded
        with ``fill`` to a multiple of S and cut into S contiguous blocks;
        on a process group: ``x`` itself (each rank passes its slice)."""
        x = torch.as_tensor(x)
        n = x.shape[0]
        if not self.in_process:
            return [x.to(self._local[0][1])], n
        s = self.num_shards
        n_pad = -(-n // s) * s
        if n_pad != n:
            pad = x.new_full((n_pad - n,) + tuple(x.shape[1:]), fill)
            x = torch.cat([x, pad.to(x.device)])
        blocks = x.reshape((s, n_pad // s) + tuple(x.shape[1:])).unbind(0)
        return [b.to(dev) for b, (_, dev) in zip(blocks, self._local)], n

    def _join(self, blocks: List[torch.Tensor], n0: int) -> torch.Tensor:
        """The reverse of :meth:`_split` (on the first shard's device)."""
        if not self.in_process:
            return blocks[0]
        dev = self._local[0][1]
        return torch.cat([b.to(dev) for b in blocks])[:n0]

    # ------------------------------------------------------------------
    # routing core (each step once for every shard this process holds)
    # ------------------------------------------------------------------

    def _agree_len(self, n: int, device) -> int:
        """The block length K is worked out from, alike on every shard: the
        blocks' length in process, the longest rank's on a process group
        (one host sync)."""
        if not self.in_process:
            self.stats["host_syncs"] += 1
        return self._x.agree_len(n, device)

    def _rank_in_owner(self, owner: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
        """Occurrence rank of each key within its destination group, in
        batch order: a one-hot cumsum up to 64 shards, the stable sort of
        ``hashtable._segment_rank`` above. The one-hot is ``[S, N]``, so
        the scan runs along the last axis (one parallel scan a shard; a
        scan along the first axis of ``[N, S]`` runs each column
        serially)."""
        s = self.num_shards
        if s > 64:
            return hashtable._segment_rank(torch.where(valid, owner, s))
        oh = owner[None, :] == torch.arange(s, dtype=owner.dtype,
                                            device=owner.device)[:, None]
        oh = oh & valid[None, :]
        csum = torch.cumsum(oh.to(torch.int32), dim=1, dtype=torch.int32)
        return torch.where(oh, csum - 1, 0).sum(dim=0, dtype=torch.int32)

    def _route(self, keys: torch.Tensor, k: int):
        """Plan the send buffer (duplicates allowed: each occurrence gets
        its own slot; the owner dedups). Returns ``(buf2 [S*K, 2] int32,
        send_pos, routed, num_dropped)``."""
        s = self.num_shards
        owner = hashing.shard_of(keys, s)
        valid = keys != self.spec.empty_key
        rank = self._rank_in_owner(owner, valid)
        send_pos = owner * k + rank
        routed = valid & (rank < k)
        buf2 = self._key_buf2(keys, torch.where(routed, send_pos, s * k), k)
        num_dropped = (valid & ~routed).sum(dtype=torch.int32)
        return buf2, send_pos, routed, num_dropped

    def _key_buf2(self, keys: torch.Tensor, pos: torch.Tensor, k: int):
        """``[S*K, 2]`` int32 (lo, hi) key buffer, EMPTY where nothing was
        sent; writes at position ``S*K`` land on a drop row that is cut
        off."""
        s = self.num_shards
        lo, hi = hashtable.split_key(keys.to(torch.int64))
        e = hashtable._split_int(int(self.spec.empty_key))
        buf = torch.tensor(e, dtype=torch.int32, device=keys.device).expand(
            s * k + 1, 2).clone()
        buf[pos.long()] = torch.stack([lo, hi], dim=-1)
        return buf[:-1]

    def _exchange_keys(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        """all_to_all the key buffers and rejoin the keys owner-side."""
        return [hashtable.join_key(r[:, 0], r[:, 1]).to(self.var.key_dtype)
                for r in self._x.all_to_all(bufs)]

    def _send_rows(self, payloads: List[torch.Tensor],
                   positions: List[torch.Tensor], k: int):
        """Each payload row at its buffer position (``S*K``: dropped) in a
        zeroed ``[S*K, ...]`` buffer, then the exchange."""
        s = self.num_shards
        bufs = []
        for p, pos in zip(payloads, positions):
            b = p.new_zeros((s * k + 1,) + tuple(p.shape[1:]))
            b[pos.long()] = p
            bufs.append(b[:-1])
        return self._x.all_to_all(bufs)

    def _init_fn(self, device):
        return self.var.row_init(device)

    def _lookup_local_train(self, shards, blocks, score_const=None):
        """Training lookup over every local shard. No batch-side dedup on
        the fast route: every occurrence routes, and each owner runs the
        one-table ``plan_lookup_train`` over its received buffer.

        Hot-key guard: when a key repeats over more than K positions of a
        block, some shard overflows; the total (``psum``) makes every
        shard branch alike into the dedup retry, where each distinct key
        routes once and its occurrences share the slot."""
        spec = self.spec
        s, d = self.num_shards, self.var.dim
        x = self._x
        flats = [b.reshape(-1) for b in blocks]
        n = self._agree_len(flats[0].shape[0], flats[0].device)
        k = self._k_per_pair(n)
        valids = [f != spec.empty_key for f in flats]
        if k >= n:
            # overflow is impossible (rank < n <= k): no psum, no retry
            routes = [self._route(f, k) for f in flats]
            deduped = False
        else:
            owners = [hashing.shard_of(f, s) for f in flats]
            ranks = [self._rank_in_owner(o, v)
                     for o, v in zip(owners, valids)]
            routed0 = [v & (r < k) for v, r in zip(valids, ranks)]
            nd0 = [(v & ~r0).sum(dtype=torch.int32)
                   for v, r0 in zip(valids, routed0)]
            deduped = x.psum(nd0) > 0  # host sync: all shards branch alike
            self.stats["host_syncs"] += 1
            routes = []
            for f, v, o, rk, r0, nd in zip(flats, valids, owners, ranks,
                                           routed0, nd0):
                if not deduped:
                    sp = o * k + rk
                    routes.append((self._key_buf2(
                        f, torch.where(r0, sp, s * k), k), sp, r0, nd))
                    continue
                uniq, inverse = hashtable.unique_static(f)
                buf2, sp_u, r_u, _ = self._route(uniq, k)
                inv = inverse.long()
                r = r_u[inv] & v
                routes.append((buf2, sp_u[inv], r,
                               (v & ~r).sum(dtype=torch.int32)))
        recv = self._exchange_keys([r[0] for r in routes])

        owner_rows, octxs = [], []
        for st, rk in zip(shards, recv):
            out = hashtable.plan_lookup_train(
                spec, st, rk, self._init_fn(st.device),
                score_const=score_const)
            (u2, inv2, (slot2, found2, ins2, drop2), packed2, no_dups2,
             aligned2, new_lo, new_hi) = out[:8]
            rows2 = hashtable.packed_value_rows(st, s * k, packed2)
            # the all-hit plans gather per occurrence (rows_aligned); only
            # a miss exchange with duplicates pays the expansion gather
            owner_rows.append(rows2 if aligned2 else rows2[inv2.long()])
            octxs.append(LookupContext(
                unique_keys=u2, slot=slot2, found=found2, rows=rows2,
                inverse=inv2, packed=packed2, inserted=ins2, dropped=drop2,
                no_dups=no_dups2, rows_aligned=aligned2, key_lo=new_lo,
                key_hi=new_hi,
                scores=out[8] if score_const is not None else None,
                ids_shape=(s * k,)))
        back = x.all_to_all(owner_rows)

        nds = [r[3] for r in routes]
        if k >= n:
            dropped_any = [0] * len(nds)
        else:
            dropped_any = x.gather_host(nds)  # host sync
            self.stats["host_syncs"] += 1
        embs = []
        for blk, f, v, (_, sp, r, _), b, nd, st in zip(
                blocks, flats, valids, routes, back, dropped_any, shards):
            taken = b[sp.clamp(0, s * k - 1).long()]
            if nd:
                # overflowed keys read their deterministic initial row
                # and skip this step's update
                fb = self._init_fn(st.device)(f).to(taken.dtype)
                taken = torch.where(r[:, None], taken, fb)
            emb = torch.where(v[:, None], taken, 0)
            embs.append(emb.reshape(tuple(blk.shape) + (d,)))
        ctx = ShardedLookupContext(
            send_pos=[r[1] for r in routes], routed=[r[2] for r in routes],
            num_dropped=nds, deduped=deduped, octx=octxs)
        return embs, ctx

    def _infer_exchange(self, shards, flats, k: int, default):
        """One inference exchange at buffer size ``k``: ``(rows, dropped)``
        per local shard; misses and dropped keys read ``default``."""
        spec = self.spec
        s = self.num_shards
        routes = [self._route(f, k) for f in flats]
        recv = self._exchange_keys([r[0] for r in routes])
        owner_rows = []
        for st, rk in zip(shards, recv):
            slot, found = hashtable.find(spec, st, rk)
            owner_rows.append(hashtable.gather(spec, st, slot, found,
                                               default.to(st.device)))
        back = self._x.all_to_all(owner_rows)
        rows = []
        for f, (_, sp, r, _), b in zip(flats, routes, back):
            dflt = default.to(b.device)
            taken = b[sp.clamp(0, s * k - 1).long()]
            out = torch.where(r[:, None], taken, dflt[None, :])
            rows.append(torch.where((f != spec.empty_key)[:, None], out, 0))
        return rows, [r[3] for r in routes]

    def _lookup_local_infer(self, shards, blocks):
        """Inference lookup: missing keys read the static default, no
        state change, exact for any owner skew: the ``capacity_factor``
        exchange first, and the worst-case one (K = n) only when some
        shard overflowed (``psum``)."""
        var = self.var
        flats = [b.reshape(-1) for b in blocks]
        n = self._agree_len(flats[0].shape[0], flats[0].device)
        default = initializers.default_value_of(
            var.initializer, var.dim, var.value_dtype, flats[0].device)
        k_fast = self._k_per_pair(n)
        rows, nds = self._infer_exchange(shards, flats, k_fast, default)
        if k_fast < n:
            self.stats["host_syncs"] += 1
            if self._x.psum(nds) > 0:  # host sync
                rows, _ = self._infer_exchange(shards, flats, n, default)
        return [r.reshape(tuple(b.shape) + (var.dim,))
                for r, b in zip(rows, blocks)]

    # ------------------------------------------------------------------
    # public ops
    # ------------------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids).to(self.var.key_dtype)

    def embedding_lookup(self, state: ShardedState, ids, *, step=None,
                         epoch=None):
        """Trainable sharded lookup: ``(emb [ids.shape + (dim,)], ctx)``.
        Any batch size (padded with EMPTY to a multiple of S, the padding
        sliced off). ``step`` (and ``epoch`` for EPOCHLRU) stamps the LRU
        score at lookup time on every owner, as
        ``Variable.embedding_lookup`` does."""
        blocks, n0 = self._split(self._ids(ids), self.spec.empty_key)
        score_const = self.var.lookup_score_const(step, epoch)
        embs, ctx = self._lookup_local_train(state.shards, blocks,
                                             score_const)
        return self._join(embs, n0), ctx

    def lookup(self, state: ShardedState, ids) -> torch.Tensor:
        """Inference lookup (missing -> static default, no state change)
        across shards; any batch size, exact for any owner skew."""
        blocks, n0 = self._split(self._ids(ids), self.spec.empty_key)
        return self._join(self._lookup_local_infer(state.shards, blocks), n0)

    def apply_gradients(self, state: ShardedState, ctx: ShardedLookupContext,
                        emb_grad, optimizer, step=0, epoch=0,
                        return_evicted: bool = False):
        """Route the gradients of ``emb`` back to their owners and apply
        the sparse optimizer there, re-using each owner's plan from the
        lookup (``ctx.octx``): no probe of its own. ``return_evicted``:
        ``(state, evicted)`` with the displaced rows as ``[shards, ...]``
        blocks."""
        opt = opt_lib.resolve_for(optimizer, self.var)
        # grads are of the unpadded emb: re-pad with zero rows to the
        # lookup's block layout
        g_blocks, _ = self._split(emb_grad, 0)
        state = self.create_slots(state, opt)
        outs = self._apply_local(
            state.shards, ctx, [g.reshape(-1, self.var.dim)
                                for g in g_blocks],
            opt, step, epoch, return_evicted)
        if return_evicted:
            return (state.replace(o[0] for o in outs),
                    _stack_evicted([o[1] for o in outs]))
        return state.replace(outs)

    def _apply_local(self, shards, ctx, grads, opt, step, epoch,
                     return_evicted):
        """Route each occurrence's grad to its buffer position (the fast
        route copies it there; the dedup route sums the occurrences that
        share a slot, in order), exchange, combine cross-source duplicates
        on the owner, run the owner's optimizer."""
        var = self.var
        n_pairs = ctx.octx[0].unique_keys.shape[0]  # S*K
        gbufs = []
        for g, sp, r in zip(grads, ctx.send_pos, ctx.routed):
            gpos = torch.where(r, sp, n_pairs).long()
            if ctx.deduped:
                # occurrences share their representative's slot: an
                # ordered sum (segment_sum_rows), the same bits every run
                gbufs.append(hashtable.segment_sum_rows(g, gpos, n_pairs))
            else:
                buf = g.new_zeros((n_pairs + 1, var.dim))
                buf[gpos] = g  # distinct slots; position n_pairs dropped
                gbufs.append(buf[:-1])
        grecv = self._x.all_to_all(gbufs)
        outs = []
        for st, octx, gr in zip(shards, ctx.octx, grecv):
            # cross-source duplicates sum onto their representative row;
            # dup-free exchanges skip the combine
            g2 = gr if octx.no_dups else hashtable.segment_sum_rows(
                gr, octx.inverse, n_pairs)
            outs.append(opt_lib.apply_gradients(
                var, st, octx, g2, opt, step=step, epoch=epoch,
                already_unique=True, return_evicted=return_evicted))
        return outs

    def train_step(self, state: ShardedState, ids, emb_grad_fn, optimizer,
                   *, step=0, epoch=0, aux_spec=None):
        """Routed lookup, gradient and apply in one call.
        ``emb_grad_fn(emb_block) -> (grad_block, aux)`` runs on each
        shard's block of the batch (padding rows are zeros and their
        grads ignored). Returns ``(state, [aux of each local shard])``
        (``aux_spec`` is the JAX signature's and unused). The batch must
        split evenly over the shards."""
        del aux_spec
        opt = opt_lib.resolve_for(optimizer, self.var)
        blocks, n0 = self._split(self._ids(ids), self.spec.empty_key)
        if self.in_process and n0 != sum(b.shape[0] for b in blocks):
            raise ValueError(
                "train_step requires a mesh-divisible batch (grads for "
                "sliced-off padding rows cannot be recovered); pad ids "
                f"to a multiple of {self.num_shards} yourself: {n0}")
        state = self.create_slots(state, opt)
        score_const = self.var.lookup_score_const(step, epoch)
        embs, ctx = self._lookup_local_train(state.shards, blocks,
                                             score_const)
        grads, auxes = [], []
        for e in embs:
            g, aux = emb_grad_fn(e)
            grads.append(g.reshape(-1, self.var.dim))
            auxes.append(aux)
        outs = self._apply_local(state.shards, ctx, grads, opt, step, epoch,
                                 False)
        return state.replace(outs), auxes

    # ------------------------------------------------------------------
    # table-wide ops
    # ------------------------------------------------------------------

    def size(self, state: ShardedState) -> torch.Tensor:
        """Live keys over every shard (0-d int64)."""
        dev = state.device
        local = torch.stack([hashtable.size(self.spec, st).to(dev)
                             for st in state.shards]).sum()
        return self._x.sum_tensor(local)

    def _per_shard(self, state: ShardedState, fn) -> ShardedState:
        return state.replace(fn(st) for st in state.shards)

    def remove(self, state: ShardedState, keys) -> ShardedState:
        """Delete keys wherever they live (every shard removes the whole
        list; misses are no-ops, so nothing routes)."""
        keys = self._ids(keys).reshape(-1)
        return self._per_shard(state, lambda st: hashtable.remove(
            self.spec, st, keys.to(st.device)))

    def clear(self, state: ShardedState) -> ShardedState:
        return self._per_shard(
            state, lambda st: hashtable.clear(self.spec, st))

    def evict_lowest(self, state: ShardedState,
                     num_evict_per_shard: int) -> ShardedState:
        """Per-shard min-score eviction (the reference's per-shard
        restriction quota)."""
        return self._per_shard(state, lambda st: hashtable.evict_lowest(
            self.spec, st, num_evict_per_shard))

    def apply_restriction(self, state: ShardedState, num_reserved: int,
                          trigger: Optional[int] = None) -> ShardedState:
        """Cap every shard to ``num_reserved // S`` live keys through the
        Variable's restrict policy (timestamp by default)."""
        s = self.num_shards
        per_shard = max(num_reserved // s, 1)
        per_trigger = None if trigger is None else max(trigger // s, 1)
        return self._per_shard(state, lambda st: self.var.restrict(
            st, per_shard, per_trigger))

    def export(self, state: ShardedState):
        """``(keys [S, C], values [S, C, D], mask [S, C])`` of the shards
        this process holds; compaction is the caller's."""
        return state.keys, state.values, self._mask(state)

    def export_keys_and_scores(self, state: ShardedState):
        return state.keys, state.scores, self._mask(state)

    def _mask(self, state: ShardedState) -> torch.Tensor:
        return torch.stack([hashtable.occupancy_mask(self.spec, st).to(
            state.device) for st in state.shards])

    def _bulk_route(self, key_blocks, last, summed=None):
        """The bulk writes' route: dedup each block, keeping each key's
        last occurrence of the ``last`` payloads and the sum of the
        ``summed`` ones (one tuple of rows a block each), route with the
        worst-case K (nothing drops) and exchange keys and payloads.
        Returns the received ``(keys, last, summed)`` per local shard."""
        s = self.num_shards
        uniqs, picked = [], []
        for i, kb in enumerate(key_blocks):
            flat = kb.reshape(-1)
            u, p = hashtable.dedup_last(flat, last[i])
            if summed is not None:
                _, p_sum = hashtable.dedup_sum(flat, summed[i])
                p = p + p_sum
            uniqs.append(u)
            picked.append(p)
        k = self._k_per_pair(self._agree_len(uniqs[0].shape[0],
                                             uniqs[0].device),
                             worst_case=True)
        routes = [self._route(u, k) for u in uniqs]
        rkeys = self._exchange_keys([r[0] for r in routes])
        pos = [torch.where(r[2], r[1], s * k) for r in routes]
        cols = [self._send_rows([p[j] for p in picked], pos, k)
                for j in range(len(picked[0]))]
        per_shard = [tuple(c[i] for c in cols) for i in range(len(rkeys))]
        n_last = len(last[0])
        return (rkeys, [p[:n_last] for p in per_shard],
                [p[n_last:] for p in per_shard])

    def upsert(self, state: ShardedState, keys, values, step=0, epoch=0,
               return_evicted: bool = False):
        """Bulk insert routed by owner; any batch size, duplicate keys keep
        the last occurrence. ``return_evicted``: ``(state, evicted)``."""
        var = self.var
        kb, _ = self._split(self._ids(keys).reshape(-1), self.spec.empty_key)
        vb, _ = self._split(torch.as_tensor(values).to(
            var.value_dtype).reshape(-1, var.dim), 0)
        rkeys, rpay, _ = self._bulk_route(kb, [(v,) for v in vb])
        outs = []
        for st, rk, (rv,) in zip(state.shards, rkeys, rpay):
            u2, (v2,) = hashtable.dedup_last(rk, (rv,))
            scores, mode = var.scores_for(u2, step=step, epoch=epoch)
            outs.append(hashtable.commit(
                var.spec, st, u2, values=v2, scores=scores,
                score_mode=mode, return_evicted=return_evicted))
        if return_evicted:
            return (state.replace(o[0] for o in outs),
                    _stack_evicted([o[1] for o in outs]))
        return state.replace(outs)

    def accum(self, state: ShardedState, keys, old_values, new_values,
              exists=None, step=0, epoch=0) -> ShardedState:
        """bp_v2 delta write routed by owner: existing rows receive
        ``new - old`` (duplicates' deltas summed), missing keys insert the
        last occurrence's ``new``. ``exists`` (captured at lookup): a key
        is written only if its presence still matches."""
        var = self.var
        d = var.dim
        kb, n = self._split(self._ids(keys).reshape(-1), self.spec.empty_key)

        def rows(a):
            return self._split(torch.as_tensor(a).to(
                var.value_dtype).reshape(-1, d), 0)[0]

        ob, nb = rows(old_values), rows(new_values)
        has_exists = exists is not None
        ex = (torch.as_tensor(exists).reshape(-1).to(torch.int32)
              if has_exists else torch.zeros((n,), dtype=torch.int32))
        eb, _ = self._split(ex, 0)
        rkeys, rlast, rdelta = self._bulk_route(
            kb, list(zip(nb, eb)), [(n - o,) for n, o in zip(nb, ob)])
        outs = []
        for st, rk, (rn, re), (d2,) in zip(state.shards, rkeys, rlast,
                                           rdelta):
            u2, (d2,) = hashtable.dedup_sum(rk, (d2,))
            _, (n2, e2) = hashtable.dedup_last(rk, (rn, re))
            if has_exists:
                _, found2 = hashtable.find(var.spec, st, u2)
                u2 = torch.where(found2 == (e2 != 0), u2, var.empty_key)
            scores, mode = var.scores_for(u2, step=step, epoch=epoch)
            outs.append(hashtable.accum(
                var.spec, st, u2, deltas=d2, values_for_new=n2,
                scores=scores, score_mode=mode))
        return state.replace(outs)

    def import_batch(self, state: ShardedState, keys, values, scores=None,
                     slot_rows=None) -> ShardedState:
        """Bulk restore routed by owner, scores and optimizer slot rows
        riding the same exchange; EMPTY padding allowed, duplicates keep
        the last occurrence."""
        var = self.var
        d = var.dim
        sdt = var.spec.score_dtype
        names = tuple(sorted((slot_rows or {}).keys()))
        keys = self._ids(keys).reshape(-1)
        if scores is None:
            scores = torch.ones(keys.shape, dtype=sdt)
        kb, _ = self._split(keys, self.spec.empty_key)
        vb, _ = self._split(torch.as_tensor(values).to(
            var.value_dtype).reshape(-1, d), 0)
        sb, _ = self._split(torch.as_tensor(scores).to(sdt).reshape(-1), 0)
        slb = [self._split(torch.as_tensor(slot_rows[nm]).to(
            var.value_dtype).reshape(-1, d), 0)[0] for nm in names]
        payloads = [(v, sc) + tuple(c[i] for c in slb)
                    for i, (v, sc) in enumerate(zip(vb, sb))]
        rkeys, rpay, _ = self._bulk_route(kb, payloads)
        outs = []
        for st, rk, rp in zip(state.shards, rkeys, rpay):
            u2, picked = hashtable.dedup_last(rk, tuple(rp))
            outs.append(hashtable.commit(
                var.spec, st, u2, values=picked[0],
                slot_rows=dict(zip(names, picked[2:])) or None,
                scores=picked[1], score_mode="assign"))
        return state.replace(outs)

    def contains(self, state: ShardedState, ids) -> torch.Tensor:
        """Residency mask: True where the key is in the table (a routed
        probe, exact for any owner skew)."""
        s = self.num_shards
        blocks, n0 = self._split(self._ids(ids).reshape(-1),
                                 self.spec.empty_key)
        uniqs, inverses = zip(*[hashtable.unique_static(b) for b in blocks])
        k = self._k_per_pair(self._agree_len(uniqs[0].shape[0],
                                             uniqs[0].device),
                             worst_case=True)
        routes = [self._route(u, k) for u in uniqs]
        recv = self._exchange_keys([r[0] for r in routes])
        found = [hashtable.find(self.spec, st, rk)[1].to(torch.int32)
                 for st, rk in zip(state.shards, recv)]
        back = self._x.all_to_all(found)
        out = []
        for u, inv, (_, sp, r, _), b in zip(uniqs, inverses, routes, back):
            got = b[sp.clamp(0, s * k - 1).long()] != 0
            got = got & r & (u != self.spec.empty_key)
            out.append(got[inv.long()])
        return self._join(out, n0)

    def import_host_arrays(self, state: ShardedState, keys, values,
                           scores=None, slot_rows=None,
                           buffer_size: int = 4 * 1024 * 1024,
                           return_evicted: bool = False):
        """Bulk restore from host arrays (numpy or CPU tensors; 16-bit
        values as tensors): partitioned by owner on the host and committed
        shard-locally through :meth:`import_local` in ``buffer_size``-row
        chunks, so no exchange buffer can overflow. ``return_evicted``
        also returns the list of each chunk's evicted rows."""
        var = self.var
        s, d = self.num_shards, var.dim
        sdt = var.spec.score_dtype
        keys = _host_tensor(keys, var.key_dtype).reshape(-1)
        values = _host_tensor(values, var.value_dtype).reshape(-1, d)
        scores = (_host_tensor(scores, sdt).reshape(-1)
                  if scores is not None
                  else torch.ones(keys.shape, dtype=sdt))
        slots = {n: _host_tensor(c, var.value_dtype).reshape(-1, d)
                 for n, c in (slot_rows or {}).items()}
        if keys.numel() == 0:
            return (state, []) if return_evicted else state
        owner = hashing.shard_of(keys, s)
        order = torch.argsort(owner, stable=True)
        keys, values, scores = keys[order], values[order], scores[order]
        slots = {n: c[order] for n, c in slots.items()}
        counts = torch.bincount(owner.long(), minlength=s)
        starts = [0] + torch.cumsum(counts, 0).tolist()
        max_per_shard = int(counts.max())
        evs = []
        m_chunk = max(1, min(buffer_size // s, max_per_shard))
        for off in range(0, max_per_shard, m_chunk):
            m = min(m_chunk, max_per_shard - off)
            k_blk = torch.full((s, m), self.spec.empty_key,
                               dtype=var.key_dtype)
            v_blk = torch.zeros((s, m, d), dtype=var.value_dtype)
            s_blk = torch.zeros((s, m), dtype=sdt)
            sl_blk = {n: torch.zeros((s, m, d), dtype=var.value_dtype)
                      for n in slots}
            for sh in range(s):
                lo = starts[sh] + off
                hi = min(starts[sh + 1], lo + m)
                if hi <= lo:
                    continue
                w = hi - lo
                k_blk[sh, :w] = keys[lo:hi]
                v_blk[sh, :w] = values[lo:hi]
                s_blk[sh, :w] = scores[lo:hi]
                for n, c in slots.items():
                    sl_blk[n][sh, :w] = c[lo:hi]
            out = self.import_local(state, k_blk, v_blk, scores=s_blk,
                                    slot_rows=sl_blk or None,
                                    return_evicted=return_evicted)
            if return_evicted:
                state, ev = out
                evs.append(ev)
            else:
                state = out
        return (state, evs) if return_evicted else state

    def import_local(self, state: ShardedState, keys, values, scores=None,
                     slot_rows=None, return_evicted: bool = False):
        """Bulk restore with no routing: ``keys [S, M]`` (``values [S, M,
        D]``, ...) are partitioned by owner already (every key of row
        ``i`` has ``shard_of(key, S) == i``), and each shard commits its
        own row; duplicates within a row keep the last occurrence.
        ``return_evicted``: ``(state, evicted)``."""
        var = self.var
        s, d = self.num_shards, var.dim
        sdt = var.spec.score_dtype
        names = tuple(sorted((slot_rows or {}).keys()))
        keys = _host_tensor(keys, var.key_dtype).reshape(s, -1)
        m = keys.shape[1]
        values = _host_tensor(values, var.value_dtype).reshape(s, m, d)
        scores = (torch.ones((s, m), dtype=sdt) if scores is None
                  else _host_tensor(scores, sdt).reshape(s, m))
        slot_args = [_host_tensor(slot_rows[n], var.value_dtype).reshape(
            s, m, d) for n in names]
        outs = []
        for (sid, dev), st in zip(self._local, state.shards):
            cols = (values[sid].to(dev), scores[sid].to(dev)) + tuple(
                c[sid].to(dev) for c in slot_args)
            uniq, picked = hashtable.dedup_last(keys[sid].to(dev), cols)
            outs.append(hashtable.commit(
                var.spec, st, uniq, values=picked[0],
                slot_rows=dict(zip(names, picked[2:])) or None,
                scores=picked[1], score_mode="assign",
                return_evicted=return_evicted))
        if return_evicted:
            return (state.replace(o[0] for o in outs),
                    _stack_evicted([o[1] for o in outs]))
        return state.replace(outs)


def _host_tensor(a, dtype) -> torch.Tensor:
    """A tensor of ``a`` (numpy or tensor) in ``dtype``, where it lies."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dtype)


def _stack_evicted(evs: List[dict]) -> dict:
    """Per-shard evicted dicts -> one dict of ``[shards, ...]`` blocks."""
    dev = evs[0]["keys"].device

    def st(xs):
        return torch.stack([x.to(dev) for x in xs])

    return {
        **{f: st([e[f] for e in evs])
           for f in ("keys", "values", "scores", "dropped_keys",
                     "dropped_values")},
        "slots": {n: st([e["slots"][n] for e in evs])
                  for n in evs[0]["slots"]},
    }
