"""Kernel 1's share of its roofline: the least time the card needs for
the gather of this step's hitting keys' rows (``roofline.counts``: bytes
over the HBM peak) over the device time of the kernels named like
``PATTERN``. Moves ``train_examples_per_s``."""

from benchmark.roofline import counts, peaks

PATTERN = "row_gather"


def read(run):
    bw = peaks.peak(run.device_kind, "hbm_bytes_per_s")
    t = run.kernel_s(PATTERN)
    if not bw or t <= 0 or not run.hit_share:
        return None
    hits = sum(h * u for h, u in zip(run.hit_share, run.unique_keys))
    return 100.0 * counts.gather_bytes(run.cfg, hits) / bw / t
