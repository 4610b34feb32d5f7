"""`de.keras` of the port: the layers under the reference's import path.
The reference's ``callbacks`` and ``models`` (checkpointing) wait for
the port of ``train/checkpoint.py``."""

from recommenders_addons_tpu_torch.keras import layers  # noqa: F401
