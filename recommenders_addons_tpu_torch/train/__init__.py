"""Training utilities of the port."""

from recommenders_addons_tpu_torch.train.loop import (  # noqa: F401
    LoopConfig,
    LoopReport,
    train_loop,
)
