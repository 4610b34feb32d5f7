"""A test-only system under test for bagged (multi-hot) configurations: the
port's DLRM whose step looks up each example's bags through the port's
public pooled API (``embedding_lookup_sparse(combiner="sum")``) and trains
the table through ``apply_sparse_gradients``. It has the interface of
``benchmark/systems/<family>.py`` (``build(cfg, device)``), so a CPU test
can hand it to ``runner.setup`` in place of the ``dlrm`` family's."""

from __future__ import annotations

import torch

from benchmark.lib import inputs


def build(cfg, device):
    from recommenders_addons_tpu_torch.models.dlrm import (
        DLRM, DLRMConfig, DLRMState, dense_optimizer_for)
    from recommenders_addons_tpu_torch.ops.sparse import (
        RaggedIds, apply_sparse_gradients, embedding_lookup_sparse)

    class PooledDLRM(DLRM):
        def make_train_step(self, dense_optimizer=None):
            tx = dense_optimizer_for(dense_optimizer, self.cfg.learning_rate)
            sizes = inputs.bag_sizes(cfg)
            cols = inputs.column_features(cfg, self.device)
            # each example's bags, one segment (example, feature) each
            starts = torch.tensor([0] + sizes, device=self.device).cumsum(0)

            def train_step(state: DLRMState, opt_state, batch):
                ids = batch["sparse"]
                b, n = ids.shape
                keys = inputs.tag(ids, cfg["feature_shift"], cols)
                splits = (torch.arange(b, device=self.device)[:, None] * n
                          + starts[None, :-1]).reshape(-1)
                splits = torch.cat([splits, splits.new_tensor([b * n])])
                bags = RaggedIds(keys.reshape(-1), splits.to(torch.int32))
                pooled, sctx = embedding_lookup_sparse(
                    self.var, state.table, bags, combiner="sum")
                emb = pooled.detach().requires_grad_(True)
                params = list(state.dense.parameters())
                loss, _ = self.loss_fn(state.dense, emb, batch["dense"],
                                       batch["label"])
                grads = torch.autograd.grad(loss, params + [emb])
                table = apply_sparse_gradients(
                    self.var, state.table, sctx, grads[-1], self.opt,
                    step=state.step + 1)
                opt_state = tx.apply(params, grads[:-1], opt_state)
                return (DLRMState(table=table, dense=state.dense,
                                  step=state.step + 1),
                        opt_state, loss.detach())

            return train_step, tx

    mc = DLRMConfig(
        num_dense=cfg["num_dense"], num_sparse=cfg["num_sparse"],
        dim=cfg["dim"], bottom_sizes=tuple(cfg["bottom_mlp"]),
        top_sizes=tuple(cfg["top_mlp"]), table_capacity=cfg["table_slots"],
        learning_rate=cfg["dense_optimizer"]["learning_rate"],
        sparse_lr=cfg["table_optimizer"]["learning_rate"])
    return PooledDLRM(mc, device=device)
