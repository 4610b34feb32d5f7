"""`de.keras` of the port: the layers, the checkpoint callbacks and
``de_save_model`` / ``de_load_model`` under the reference's import
path."""

from recommenders_addons_tpu_torch.keras import callbacks  # noqa: F401
from recommenders_addons_tpu_torch.keras import layers  # noqa: F401
from recommenders_addons_tpu_torch.keras import models  # noqa: F401
