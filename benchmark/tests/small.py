"""Small configurations of the benchmark's cells, for the CPU tests: the
cells' own files with the widths, vocabulary, table and batch cut so that
a run takes seconds on the CPU."""

from __future__ import annotations

import copy

from benchmark.lib import manifest


def small(cell_name: str):
    """``(manifest, cell, cfg, mix)`` of ``cell_name``, cut to CPU size."""
    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    cfg = copy.deepcopy(manifest.config(man, cell["config"]))
    mix = copy.deepcopy(manifest.traffic(cell["traffic"]))
    cfg["num_sparse"] = 4
    cfg["num_embeddings_per_feature"] = [700, 3, 40, 900]
    cfg["max_ind_range"] = 600
    # 16 buckets of 64 for 1,243 vocabulary keys: as in the cells, some
    # keys do not fit their bucket, miss when drawn and evict
    cfg["table_slots"] = 1 << 10
    cfg["dim"] = 8
    cfg["bottom_mlp"], cfg["top_mlp"] = [16, 8], [16, 1]
    mix["batch"] = 64
    mix["prefill"]["chunk"] = 256
    mix["pool_batches"] = 12
    mix["trace"] = {"timed_steps": 2, "traced_steps": 2, "sync_steps": 1}
    return man, cell, cfg, mix
