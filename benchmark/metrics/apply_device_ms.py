"""Device ms per step of the kernels launched under the table apply
(``Variable.apply_gradients``: the duplicate-gradient combine and kernel
3). Moves ``train_examples_per_s``."""

from benchmark.lib.trace import APPLY_RANGE


def read(run):
    s = run.range_device_s.get(APPLY_RANGE, 0.0)
    return s / run.steps * 1e3 if s > 0 and run.steps else None
