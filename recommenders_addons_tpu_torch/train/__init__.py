"""Training utilities of the port: the loop and the checkpoint / saver
subsystem."""

from recommenders_addons_tpu_torch.train.checkpoint import (  # noqa: F401
    DE_DIR_NAME,
    DECheckpoint,
    latest_checkpoint,
    load_dynamic_embedding,
    load_tier,
    save_dynamic_embedding,
    save_tier,
)
from recommenders_addons_tpu_torch.train.loop import (  # noqa: F401
    LoopConfig,
    LoopReport,
    train_loop,
)
from recommenders_addons_tpu_torch.train.saver import DEHvdSaver  # noqa: F401
