"""Run one cell of the port's benchmark on the card this process sees:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` ``breakdown``), and last ``checks``:
each number that decided ``correct`` beside its limit, also printed as the
last lines of standard error. Exits non-zero, printing no result, when
there is no card (or fewer than the cell asks for), when the port cannot
be imported, or when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "recommenders_addons_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the run must not load,
    compared whole (the port's own name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import check, manifest

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import recommenders_addons_tpu_torch  # noqa: F401  the system under test

    cfg = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"], ROOT)
    limits = check.limits_for(cell["name"], ROOT)
    kind = torch.cuda.get_device_name(0)
    result = run_cell(man, cell, cfg, mix, limits, args.seed, args.seconds,
                      args.trace, torch.device("cuda", 0), kind)
    if result is None:
        return 3
    stages = result.pop("stages")
    setup_peak = result.pop("setup_peak_bytes")
    print(json.dumps(result), flush=True)
    # peaks assume the full power limit: the card's own is printed beside
    print(f"card: {kind}, power limit {_power_limit()} W", file=sys.stderr)
    print("set-up stages (s): " + json.dumps(stages), file=sys.stderr)
    print(f"device memory peak of set-up: {setup_peak} bytes",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


def run_cell(man, cell, cfg, mix, limits, seed, seconds, trace, dev, kind,
             plant=None, t_start=None):
    """One run of ``cell`` on ``dev``: the result's dict, or None when a
    module that must not load was loaded. ``plant`` may break the system
    under test (the fault tests); set-up is timed from ``t_start``
    (default: this module's start)."""
    import torch

    from benchmark import metrics as metric_readers
    from benchmark.lib import manifest, runner, timing

    if trace:
        tr = mix["trace"]
        pool_n = (int(mix["check_steps"]) + int(mix.get("warmup_steps", 0))
                  + int(tr["timed_steps"]) + int(tr["traced_steps"])
                  + int(tr["sync_steps"]))
    else:
        pool_n = int(mix["pool_batches"])
    session = runner.setup(cfg, mix, seed, dev, pool_n, plant=plant)
    torch.cuda.synchronize()
    t_start = T_START if t_start is None else t_start
    setup_s = time.perf_counter() - t_start - session.check_s
    # the device's peak is the window's: set-up's transients (the table's
    # copy when its slot is added) are reported apart
    setup_peak = int(torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)

    device = {"platform": "gpu", "kind": kind, "count": 1}
    out = {}
    if not trace:
        steps, window_s, step_ms = runner.window(session, seconds)
        attempted = steps
        values = {"train_examples_per_s": steps * mix["batch"] / window_s,
                  "step_ms_p95": timing.percentile(step_ms, 95.0),
                  "setup_s": setup_s}
    else:
        run = runner.traced(session, kind)
        attempted = run.steps
        values = {}
        for m in manifest.metrics_for(man, "per_layer", cell["name"]):
            v = metric_readers.load(m["name"]).read(run)
            if v is not None:
                values[m["name"]] = v
        device["busy_s"] = run.busy_s
        device["window_s"] = run.window_s
        top = sorted(run.device_ops.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {
            "device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k[:120], v] for k, v in run.idle_gaps]}
    torch.cuda.synchronize()
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    if _refuse_forbidden():
        return None
    section = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in man[section]}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()}

    runner.release(session)
    t_ref = time.perf_counter()
    ok, checks, _ = runner.judge(session, limits)
    session.stages["check_reading"] = session.check_s
    session.stages["reference"] = time.perf_counter() - t_ref
    if _refuse_forbidden():
        return None
    result = {"correct": ok, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device}
    result.update(out)
    result["stages"] = session.stages
    result["setup_peak_bytes"] = setup_peak
    result["checks"] = checks
    return result


def _refuse_forbidden() -> bool:
    found = loaded_forbidden()
    if found:
        print(f"modules that must not load were loaded: {found}",
              file=sys.stderr)
    return bool(found)


if __name__ == "__main__":
    sys.exit(main())
