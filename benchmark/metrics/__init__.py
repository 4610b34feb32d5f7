"""Per-layer metric readers: ``benchmark/metrics/<metric name>.py``, each
with ``read(run) -> float | None`` over a ``lib.trace.TraceRun``. A reader
that finds nothing to read returns None, and the metric is left out of
the run's line."""

import importlib.util
from pathlib import Path


def load(name: str):
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
