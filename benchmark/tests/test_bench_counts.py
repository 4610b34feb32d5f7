"""The FLOP and byte counters against hand counts."""

from benchmark.roofline import counts, peaks
from benchmark.lib import manifest

MAN = manifest.load()


def _cfg(name):
    return manifest.config(MAN, name)


def test_dlrm_flops_by_hand():
    cfg = _cfg("dlrm-criteo-tb")
    bottom = 13 * 512 + 512 * 256 + 256 * 64
    top = 415 * 512 + 512 * 512 + 512 * 256 + 256 * 1
    pairs = 27 * 26 // 2
    want = 4 * 13 * 512 + 6 * (bottom - 13 * 512) + 6 * top + 6 * pairs * 64
    assert counts.train_flops_per_example(cfg) == want
    # about 38.4 GFLOP a step of 8,192 examples
    assert abs(want * 8192 / 1e9 - 38.35) < 0.01


def test_row_bytes_by_hand():
    cfg = _cfg("dlrm-criteo-tb")
    # value and accumulator, 64 words each, read and written, an index
    assert counts.gather_bytes(cfg, 10) == 10 * (2 * 512 + 4)
    # packed row read, row written, gradient read, an index
    assert counts.apply_bytes(cfg, 10) == 10 * (512 + 512 + 256 + 4)


def test_peaks_table():
    assert peaks.peak("NVIDIA H100 80GB HBM3", "f32_flops") == 67e12
    assert peaks.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert peaks.peak("some other card", "f32_flops") is None
