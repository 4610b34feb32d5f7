"""Utilities of the port: environment configuration, metrics and
profiling."""

from recommenders_addons_tpu_torch.utils.config import env_config  # noqa: F401
from recommenders_addons_tpu_torch.utils import metrics  # noqa: F401
from recommenders_addons_tpu_torch.utils import profiling  # noqa: F401
