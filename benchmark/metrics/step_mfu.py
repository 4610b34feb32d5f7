"""The whole step's share of the card's float32 peak (the towers run in
float32 with TF32 off): the model's training FLOPs per step
(``roofline.counts``) over the mean step time of untraced steps (CUDA
events) times the peak. Moves ``train_examples_per_s``."""

from benchmark.roofline import counts, peaks


def read(run):
    peak = peaks.peak(run.device_kind, "f32_flops")
    ms = run.step_ms_untraced
    if not peak or not ms:
        return None
    flops = counts.train_flops_per_example(run.cfg) * run.mix["batch"]
    return 100.0 * flops / (ms / 1e3) / peak
