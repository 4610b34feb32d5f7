"""Readings for a cell's correctness limits, on the card at the cell's own
size, many seeds in one process (set-up is long):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--controls 3]

For every seed: the program's numbers (its three checked steps against
the reference). For the first ``--controls`` seeds also the control (the
reference in TF32 in the program's place) and the planted faults (the
reference with half of each batch left out, and with a looked-up row
altered, in the program's place). Prints one JSON line per reading and
writes them to ``chiprun_out/calibrate_<cell>.jsonl``. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one process builds a 34 GB table and its slot copy per seed: without
# expandable segments the freed containers fragment the cache
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--program-faults", type=int, default=1,
                    help="seeds on which each fault of lib/faults.py is "
                         "also planted in the program")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import check, faults, manifest, runner
    from benchmark.reference import train as ref_train

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    mix = copy.deepcopy(manifest.traffic(cell["traffic"], ROOT))
    mix["warmup_steps"] = 0
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / f"calibrate_{cell['name']}.jsonl", "a")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    for i, seed in enumerate(args.seeds):
        fresh()
        t0 = time.perf_counter()
        s = runner.setup(cfg, mix, seed, dev, int(mix["check_steps"]))
        if i == 0:
            from recommenders_addons_tpu_torch.utils.metrics import (
                table_stats)

            st = table_stats(s.trainer.model.var.spec, s.trainer.state.table)
            emit({"cell": cell["name"], "seed": seed, "kind": "table",
                  "stats": st.as_dict(), "stages": s.stages,
                  "memory_peak_bytes": torch.cuda.max_memory_allocated()})
        runner.release(s)
        t1 = time.perf_counter()
        batches = runner.check_batches(s)
        ref = ref_train.run(cfg, mix, seed, s.plan, s.weights, batches)
        t_ref = time.perf_counter() - t1
        nums = check.compare(cfg, ref, s.weights, prog=s.readings)
        emit({"cell": cell["name"], "seed": seed, "kind": "program",
              "numbers": nums, "losses": s.readings.losses,
              "setup_s": t1 - t0, "reference_s": t_ref,
              "keys1": int(ref.keys1.numel()),
              "written1": int(ref.written1.sum()),
              "keys3": int(ref.keys3.numel()),
              "resident3": int(ref.resident3.sum()),
              "candidates": int(ref.candidates.numel())})
        if i < args.controls:
            for kind, kw in (("control_tf32", {"precision": "tf32"}),
                             ("fault_half_batch", {"fault": "half_batch"}),
                             ("fault_altered_row",
                              {"fault": "altered_row"})):
                other = ref_train.run(cfg, mix, seed, s.plan, s.weights,
                                      batches, **kw)
                emit({"cell": cell["name"], "seed": seed, "kind": kind,
                      "numbers": check.compare(cfg, ref, s.weights,
                                               other=other)})
        # a step that leaves its state unchanged reads 1 by the change's
        # measure and is not run here (it would copy the whole table)
        planted = [(k, v) for k, v in faults.FAULTS.items()
                   if k != "stale_step"]
        for name, plant in (planted if i < args.program_faults else ()):
            fresh()
            restores = []

            def keep(trainer, plant=plant):
                plant(trainer)
                if getattr(trainer, "restore", None):
                    restores.append(trainer.restore)

            try:
                f = runner.setup(cfg, mix, seed, dev,
                                 int(mix["check_steps"]), plant=keep)
            finally:
                for undo in restores:
                    undo()
            runner.release(f)
            emit({"cell": cell["name"], "seed": seed,
                  "kind": f"program_fault_{name}",
                  "numbers": check.compare(cfg, ref, s.weights,
                                           prog=f.readings)})
            del f
        del s, ref, batches
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
