"""Device ms per step of the kernels launched under the table lookup
(``Variable.embedding_lookup``: the probe, the plan of the miss branch,
the initial rows, kernel 1). Moves ``train_examples_per_s``."""

from benchmark.lib.trace import LOOKUP_RANGE


def read(run):
    s = run.range_device_s.get(LOOKUP_RANGE, 0.0)
    return s / run.steps * 1e3 if s > 0 and run.steps else None
