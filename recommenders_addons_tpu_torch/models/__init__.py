"""Models of the port."""

from recommenders_addons_tpu_torch.models import (  # noqa: F401
    dcn,
    dlrm,
    movielens,
)
