"""Dense layers of the port."""

from recommenders_addons_tpu_torch.nn.mlp import MLP  # noqa: F401
