"""The port's DLRM-DCNv2 (``models/dlrm_dcnv2.py``) for a ``family:
dlrm_dcnv2`` configuration."""

from __future__ import annotations


def build(cfg, device):
    from recommenders_addons_tpu_torch.models.dlrm_dcnv2 import (
        DLRMDCNv2, DLRMDCNv2Config)

    from benchmark.lib import inputs

    mc = DLRMDCNv2Config(
        num_dense=cfg["num_dense"],
        multi_hot_sizes=tuple(inputs.bag_sizes(cfg)), dim=cfg["dim"],
        bottom_sizes=tuple(cfg["bottom_mlp"]),
        top_sizes=tuple(cfg["top_mlp"]), cross_layers=cfg["cross_layers"],
        cross_rank=cfg["cross_rank"], table_capacity=cfg["table_slots"],
        learning_rate=cfg["dense_optimizer"]["learning_rate"],
        sparse_lr=cfg["table_optimizer"]["learning_rate"])
    return DLRMDCNv2(mc, device=device)
