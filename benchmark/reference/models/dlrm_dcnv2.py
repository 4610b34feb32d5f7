"""DLRM-DCNv2 (MLPerf Training's ``recommendation_v2/torchrec_dlrm``;
TorchRec's ``DLRM_DCN``): a bottom MLP on the dense features with a ReLU
after every layer, the last included (``DenseArch``); ``x_0``, the bottom
output then the F pooled bags; a low-rank cross network, ``x_{l+1} = x_0 *
((x_l @ v_l) @ w_l + b_l) + x_l`` (``LowRankCrossNet``); a top MLP to one
logit, no ReLU after its last layer (``OverArch``)."""

import torch

from benchmark.reference.dense import matmul, tower, tower_shapes

RAW_INPUT = {"bottom.w.0"}


def _width(cfg):
    return cfg["bottom_mlp"][-1] + cfg["num_sparse"] * cfg["dim"]


def shapes(cfg):
    width, rank = _width(cfg), cfg["cross_rank"]
    out = tower_shapes("bottom", [cfg["num_dense"]] + cfg["bottom_mlp"])
    for i in range(cfg["cross_layers"]):
        out[f"cross.v.{i}"] = (width, rank)
        out[f"cross.w.{i}"] = (rank, width)
        out[f"cross.b.{i}"] = (width,)
    out.update(tower_shapes("top", [width] + cfg["top_mlp"]))
    return out


def extra_train_flops(cfg):
    """Every product is a weight matrix's."""
    return 0


def logits(cfg, w, x_dense, emb):
    b = x_dense.shape[0]
    bottom = torch.relu(tower(w, "bottom", len(cfg["bottom_mlp"]), x_dense))
    x0 = torch.cat([bottom, emb.reshape(b, -1)], dim=1)
    x = x0
    for i in range(cfg["cross_layers"]):
        x = x0 * (matmul(matmul(x, w[f"cross.v.{i}"]), w[f"cross.w.{i}"])
                  + w[f"cross.b.{i}"]) + x
    return tower(w, "top", len(cfg["top_mlp"]), x).reshape(b)
