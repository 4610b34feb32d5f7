"""DLRM (Naumov et al., arXiv:1906.00091): a bottom MLP on the dense
features, the dot products of every pair of the F+1 vectors (row-major
upper-triangle order, the port's), a top MLP on the bottom output and
those products."""

import numpy as np
import torch

from benchmark.reference.dense import bmm, tower, tower_shapes

RAW_INPUT = {"bottom.w.0"}


def shapes(cfg):
    f = cfg["num_sparse"] + 1
    top_in = cfg["dim"] + f * (f - 1) // 2
    out = tower_shapes("bottom", [cfg["num_dense"]] + cfg["bottom_mlp"])
    out.update(tower_shapes("top", [top_in] + cfg["top_mlp"]))
    return out


def extra_train_flops(cfg):
    """The pair dot products: ``2 * pairs * dim`` forward, twice that
    backward."""
    f = cfg["num_sparse"] + 1
    return 6 * (f * (f - 1) // 2) * cfg["dim"]


def logits(cfg, w, x_dense, emb):
    b = x_dense.shape[0]
    bottom = tower(w, "bottom", len(cfg["bottom_mlp"]), x_dense)
    z = torch.cat([bottom[:, None, :], emb], dim=1)
    inter = bmm(z, z.transpose(1, 2))
    iu, ju = np.triu_indices(z.shape[1], k=1)
    iu = torch.from_numpy(iu).to(z.device)
    ju = torch.from_numpy(ju).to(z.device)
    top_in = torch.cat([bottom, inter[:, iu, ju]], dim=-1)
    return tower(w, "top", len(cfg["top_mlp"]), top_in).reshape(b)
