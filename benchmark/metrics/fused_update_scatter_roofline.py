"""Kernel 3's share of its roofline: the least time the card needs for
the Adagrad apply of this step's written rows (``roofline.counts``: bytes
over the HBM peak) over the device time of the kernels named like
``PATTERN``. Moves ``train_examples_per_s``."""

from benchmark.roofline import counts, peaks

PATTERN = "fused_kernel"


def read(run):
    bw = peaks.peak(run.device_kind, "hbm_bytes_per_s")
    t = run.kernel_s(PATTERN)
    if not bw or t <= 0 or not run.hit_share:
        return None
    written = sum(h * u + i for h, u, i in zip(run.hit_share,
                                               run.unique_keys,
                                               run.inserted))
    return 100.0 * counts.apply_bytes(run.cfg, written) / bw / t
