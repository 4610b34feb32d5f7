"""The port's DLRM (``models/dlrm.py``) for a ``family: dlrm``
configuration."""

from __future__ import annotations


def build(cfg, device):
    from recommenders_addons_tpu_torch.models.dlrm import DLRM, DLRMConfig

    mc = DLRMConfig(
        num_dense=cfg["num_dense"], num_sparse=cfg["num_sparse"],
        dim=cfg["dim"], bottom_sizes=tuple(cfg["bottom_mlp"]),
        top_sizes=tuple(cfg["top_mlp"]), table_capacity=cfg["table_slots"],
        learning_rate=cfg["dense_optimizer"]["learning_rate"],
        sparse_lr=cfg["table_optimizer"]["learning_rate"])
    return DLRM(mc, device=device)
