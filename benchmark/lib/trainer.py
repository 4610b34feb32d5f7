"""The system under test, as one object: the port's model for a
configuration, its table with the optimizer's slot, its dense weights and
optimizer state, and the step that the window drives
(``train.loop.train_loop`` over ``make_train_step``'s step).

Set-up makes the object once; the checked steps and the window use the
same object and the same call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from benchmark import systems
from benchmark.lib import inputs


class ConfigMismatch(RuntimeError):
    """The program would not run as the configuration states."""


class Trainer:
    def __init__(self, cfg, device, seed: int):
        from recommenders_addons_tpu_torch import dynamic_embedding as de

        self.cfg = cfg
        self.device = torch.device(device)
        self.model = systems.load(cfg["family"]).build(cfg, self.device)
        state = self.model.init(seed & 0xFFFFFFFF)
        state = dataclasses.replace(state, table=de.create_slots(
            self.model.var, state.table, self.model.opt))
        self.state = state
        self.train_step, self.tx = self.model.make_train_step()
        self._verify()
        self.opt_state = None

    # -- what runs is what the configuration states --------------------

    def _verify(self) -> None:
        from recommenders_addons_tpu_torch.models.dlrm import OptaxAdagrad
        from recommenders_addons_tpu_torch.ops import initializers
        from recommenders_addons_tpu_torch.ops.optimizer import Adagrad
        from recommenders_addons_tpu_torch.ops.variable import EvictStrategy

        cfg, var, opt = self.cfg, self.model.var, self.model.opt
        topt, dopt = cfg["table_optimizer"], cfg["dense_optimizer"]
        init = var.initializer
        checks = {
            "table_slots": var.spec.capacity == cfg["table_slots"],
            "bucket_size": var.spec.bucket_size == cfg["bucket_size"],
            "table_name": var.name == cfg["table_name"],
            "value_dtype": var.value_dtype == torch.float32,
            "evict": var.evict_strategy == EvictStrategy.LRU,
            "initializer": (isinstance(init, initializers.uniform)
                            and init.scale == cfg["initializer_scale"]),
            "table_optimizer": (
                isinstance(opt, Adagrad)
                and opt.learning_rate == topt["learning_rate"]
                and opt.initial_accumulator_value
                == topt["initial_accumulator_value"]
                and opt.epsilon == topt["epsilon"]),
            "dense_optimizer": (
                isinstance(self.tx, OptaxAdagrad)
                and self.tx.learning_rate == dopt["learning_rate"]
                and self.tx.initial_accumulator_value
                == dopt["initial_accumulator_value"]
                and self.tx.eps == dopt["epsilon"]),
            "tf32_off": not torch.backends.cuda.matmul.allow_tf32,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise ConfigMismatch(f"the program departs from the "
                                 f"configuration in: {bad}")

    # -- inputs ---------------------------------------------------------

    def load_weights(self, weights: Dict[str, torch.Tensor]) -> None:
        named = dict(self.state.dense.named_parameters())
        if set(named) != set(weights):
            raise ConfigMismatch(f"dense leaves {sorted(named)} against "
                                 f"the reference's {sorted(weights)}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(weights[name])
        self.opt_state = self.tx.init(list(self.state.dense.parameters()))

    def prefill(self, plan: inputs.Prefill, seed: int) -> None:
        """The prefill through the port's bulk restore path
        (``Variable.import_batch``), one chunk at a time."""
        var, dim = self.model.var, self.cfg["dim"]
        slot = sorted(self.model.opt.slot_specs())[0]
        table = self.state.table
        for c in range(plan.n_chunks):
            lo, hi = plan.span(c)
            values, acc = plan.rows(seed, c, dim)
            table = var.import_batch(table, plan.keys[lo:hi], values,
                                     scores=plan.scores[lo:hi],
                                     slot_rows={slot: acc})
        self.state = dataclasses.replace(self.state, table=table)

    # -- the step -------------------------------------------------------

    def step_fn(self, carry, batch):
        """``train_loop``'s ``step_fn``: one call of the model's step."""
        state, opt_state = carry
        state, opt_state, loss = self.train_step(state, opt_state, batch)
        return (state, opt_state), loss

    @property
    def carry(self):
        return self.state, self.opt_state

    @carry.setter
    def carry(self, value) -> None:
        self.state, self.opt_state = value

    # -- reading the program's state ------------------------------------

    def dense_names(self):
        return [n for n, _ in self.state.dense.named_parameters()]

    def dense_values(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone()
                for n, p in self.state.dense.named_parameters()}

    def dense_accumulators(self) -> Dict[str, torch.Tensor]:
        return {n: a.clone()
                for n, a in zip(self.dense_names(), self.opt_state)}

    def rows(self, keys: torch.Tensor, block: int = 1 << 20):
        """``(found [N], values [N, D], slot [N, D])`` of ``keys`` in the
        table now, through the table's own probe and row views."""
        from recommenders_addons_tpu_torch.ops import hashtable

        var, table = self.model.var, self.state.table
        slot_name = sorted(self.model.opt.slot_specs())[0]
        found, vals, accs = [], [], []
        for lo in range(0, keys.shape[0], block):
            k = keys[lo:lo + block]
            slot, f = hashtable.find(var.spec, table, k)
            s = slot.long()
            found.append(f)
            vals.append(table.values[s].clone())
            accs.append(table.slots[slot_name][s].clone())
        return torch.cat(found), torch.cat(vals), torch.cat(accs)

    def planes(self):
        """The key planes and scores now, as a state that can only be
        probed (``(spec, state)``)."""
        from recommenders_addons_tpu_torch.ops import hashtable

        t = self.state.table
        empty = t.rows.new_zeros((1, t.rows.shape[1]))
        return self.model.var.spec, hashtable.TableState(
            key_lo=t.key_lo.clone(), key_hi=t.key_hi.clone(), rows=empty,
            scores=t.scores.clone(), dim=t.dim, slot_names=t.slot_names,
            slot_inits=t.slot_inits, key_dtype_name=t.key_dtype_name,
            value_dtype_name=t.value_dtype_name)
