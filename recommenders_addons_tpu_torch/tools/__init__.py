"""The port's kernel measurement tools, each named after its counterpart
in the repository's ``tools/`` (the JAX package's tools):
``dma_bench`` (row copies), ``ab_kernel_cost`` (the fused-apply cost
probe) and ``ab_radix_plan`` (the radix-histogram probe), plus the
port's own tools (no counterpart): the ring-geometry sweeps
``gather_sweep``, of the two pipelined gathers, and ``fused_sweep``, of
the fused optimizer-scatter, ``row_sweep``, of the row gather and row
scatter, and ``hist_bench``, the histogram kernel against the launch
floor. Each runs as
``python -m recommenders_addons_tpu_torch.tools.<name>``; the modules
load on first access, so running one that way does not import it
twice."""

import importlib

__all__ = ["ab_kernel_cost", "ab_radix_plan", "dma_bench", "fused_sweep",
           "gather_sweep", "hist_bench", "row_sweep"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
