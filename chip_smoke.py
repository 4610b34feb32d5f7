#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recommenders_addons_tpu_torch) on
one NVIDIA card: builds the hand-written CUDA kernels from csrc/, holds
each against its plain PyTorch version at its main paths' shapes, serves
a DLRM-width dynamic-embedding table through the port's EmbeddingServer
(and through the gRPC front end's Lookup handler, without its transport),
trains the full-width DLRM through train_loop, runs the table-step
benchmark's configuration through hit, duplicate, fresh-key and eviction
batches, trains that table with the optax-style sparse optimizer
(OptaxSparseOptimizer over transforms.adam) beside the named fused Adam,
runs the rest of the training surface (deferred dedup,
bp_v2, evicted rows, the KV API), trains the model families built on the
sparse lookup API (DCN at full width, MovieLens, two-tower retrieval,
seq-and-dense) and the sparse API itself, runs the table lifecycle
(checkpoint round trip, restrict policies, grow, chunked export), the
sharded table (parallel/: the DLRM on 4 logical shards of the card, the
NCCL process-group exchange, sharded checkpoints), the spill tier
(DLRM's table under a HybridTable with twice its capacity in keys, its
host store, checkpoints, tiered serving and the networked shared tier),
the f64, int64 and bool tables, the input pipeline with the examples
built on it, and the kernel tools, checking each result against a
reference.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. Kernels against their plain versions. row_gather on a 4Mi-row table
   (ch = 1) at N = 65536, on a ragged N with sentinel and negative
   indices (masked and flat), and on a ch = 2 table with the vc = 1 value
   stride; row_scatter of 1Mi rows with unique indices plus sentinels:
   bit-exact on int32 views (the scatter on rows [0, C): it does no work
   for rows bound for the trash row, whose contents are unspecified).
   fused_update_scatter for all seven named optimizers on f32 tables and
   for Adam and Adagrad on bf16 tables (with a foreign slot column passed
   through, sentinel, negative and past-the-end indices), then at the
   three inputs of tools/fused_sweep.py: DLRM's shape (Adagrad, 4Mi
   rows, ch = 1, N = 106,496), the table step's (Adam, 2Mi rows,
   ch = 2, N = 65,536) and the main path's own operands (one full-width
   DLRM step's call, about two thirds of its rows bound for the trash
   row, which the kernel leaves alone). Rows [0, C) it does not write must be
   bit-exact, updated f32 words within 4 ulps and bf16 halves within 1.
   Each kernel is timed (CUDA events) beside its plain version, one
   PyTorch library call computing the same function where there is one,
   and its bound: the bytes it must move over the card's memory rate
   (row_scatter's counts each row with a valid index read and written
   once, plus 4 B an index; ``old_bound_ms`` beside it counts every
   input row read, as the port did until the kernel skipped trash rows).
   fused_update_scatter's row also gives the table step's and the main
   path's times (``table_step_ms``, ``main_path_ms``), their bounds (as
   its own: the rows with a valid index, each reading its value and slot
   words and grads and writing its whole row, plus 4 B an index), the
   bytes the kernel moves (``*moved_bytes``) and the main path's share
   of trash rows (``main_path_trash_share``).
   init_rows (kernel 10) at one DLRM step's own call: 8,192 x 26
   positions of ids uniform over 150,000 (~113k distinct, the
   uniform-warm cell's), each key's first position its representative,
   130 of those new (inserted), the rest found; every other position
   EMPTY and not found, as plan_lookup hands them over. On the f32 block
   (the logical layout, value and Adagrad slot: W = 128) and the bf16
   one (physical, W = 256 halves): bit-exact against its plain version
   (uniform(0.05)), timed beside it, its bound the bytes it must move
   (keys and flags read, not-found rows' values and inserted rows' slot
   columns written); normal(0.05) within 4 f32 / 1 bf16 ulp. Then a
   miss-branch Variable.embedding_lookup must launch it once, an all-hit
   one not at all.
2. The serving slice: a Variable(dim=64, init_capacity=1<<22) filled with
   26 features x 80,658 feature-tagged ids (the DLRM shared table's
   layout, models/dlrm.py), export_compressed to f16, serve_directory
   (load_compressed into a 4Mi-slot table), 8 EmbeddingClient requests
   of 256 examples x 26 features with zipf(1.2) ids, 4 of them
   concurrent, each held exactly against the numpy reference. Then
   FrozenTable.lookup is timed at N = 65536 (CUDA events, then a
   torch.profiler trace for the device's busy share and top kernels), and
   the requests' latency beside the server's table layer alone. Then the
   gRPC front end's Lookup on the same served table without its
   transport (the smoke imports no grpc): 8 requests packed, passed
   through grpc_server.lookup_bytes (the codec, the server's _Batcher,
   FrozenTable.lookup: row_gather) and unpacked, each bit-equal to the
   numpy reference and its response bytes equal to the codec's packing of
   the HTTP answer; an unknown table raises UnknownTableError; 16 more
   timed (host clock, p50 and max), with the codec's share.
3. Training: a narrow DLRM trains 3 steps on the card and 3 on the CPU
   (the plain versions) from the same weights and batches; losses, key
   planes, scores and rows must agree. Then the full-width DLRM
   (DLRMConfig: dim 64, 26 features, towers 13-512-256-64 and
   415-512-256-1, a 4Mi-slot table with its Adagrad accumulator) trains
   20 steps of batch 4096 through train_loop; the loss must be finite and
   lower at step 20 than at step 1. Timed per step, with a profiler trace
   of 3 more steps and a count of the host syncs of one step.
4. The table step (bench.py's configuration: dim 64, 2Mi slots, Adam,
   normal(0.05)): embedding_lookup + apply_gradients on batches of 65,536
   ids: fresh, all-hit, zipf duplicates, fresh again, and, after filling
   the table to capacity, fresh ids that must evict.
4b. The optax-style sparse optimizer at the table step's width: dim 64,
   2Mi slots, f32, DynamicEmbeddingOptimizer(transforms.adam(1e-3)) (slot
   columns optax_0 (the per-row step count), optax_1, optax_2: 1 KiB
   rows), 2 warm and 10 timed steps of 65,536 zipf(1.2) ids from a
   universe of 1Mi keys (nothing evicted), one step under the sync
   counter and 4 under torch.profiler; the same steps on a same-shape
   table with the named fused Adam (ms/step of both, host syncs, the
   card's busy share). The adapter takes the unfused path: row_gather
   and row_scatter must launch, fused_update_scatter must not. (a) Every
   key's count column equals the number of steps whose batch held it,
   as numpy counts them. (b) Dim 8, 4,096 slots, 5 steps of 1,024 zipf
   ids from 2,048 keys on the card and on the CPU: key planes, scores
   and count columns bit-exact, rows and moments within rtol 1e-5 /
   atol 1e-6. (c) 4 logical shards of the card with the adapter, 3
   steps of (a)'s width, per key against one table: counts bit-exact,
   rows within rtol 1e-5 / atol 1e-6 (row_gather and row_scatter must
   launch).
5. The rest of the training surface at the table step's width
   (Variable(dim=64, init_capacity=2Mi, Adam(0.001), LRU, normal(0.05)),
   batches of 65,536 ids): (a) 10 zipf-duplicate steps with deferred
   dedup (fused_update_scatter every step) against the same steps with
   eager dedup from a copy of the starting state: key and score planes
   bit-exact, rows within rtol 1e-5 / atol 1e-6, ms/step of both, and
   the ulps between two deferred runs; (b) 5 bp_v2 steps (the unfused
   path: row_gather and row_scatter, no fused_update_scatter) against the
   assigning apply, planes bit-exact, rows within the same tolerance;
   (c) return_evicted on the fused and the unfused (bp_v2) path, a full
   table taking 65,536 fresh ids (100 of them in one bucket): the
   evicted keys are exactly the keys that left the table, their values,
   slots and scores bit-exact against the table before the step, the
   dropped keys exactly the fresh ids not placed; (d) import_batch of
   1Mi (key, value, score, Adam slot rows) with 5% duplicate keys (last
   occurrence wins, bit-exact), accum of 65,536 ids with duplicates and
   the exists guard (per-key sums of a numpy f64 reference within rtol
   1e-5 / atol 1e-5; skipped keys bit-exact), remove of half the keys,
   clear; (e) plan_lookup_fast on all-hit dup-free, all-hit duplicate and
   miss batches against plan_lookup's contract.
6. The models on the sparse lookup API. (a) DCNConfig() (26 sparse and
   13 dense features, dim 32, 3 cross layers of 845 x 845, deep tower
   256-128, a 4Mi-slot table with its Adagrad accumulator) trains 20
   steps of batch 4096 through train_loop: the loss finite at every
   step, ms/step, host syncs of one step, a profiler trace of 3; then
   row_gather and fused_update_scatter on one more step's own operands
   against their plain versions (bit-exact; 4 f32 ulps). (b) A narrow
   DCN trains 3 steps on the card and on the CPU from the same weights:
   key planes, scores and size bit-exact, losses and rows within rtol
   1e-4 / atol 1e-5. (c) The sparse API at DCN's table width (dim 32,
   Adagrad, 256Ki slots): 8,192 rows of up to 8 zipf ids (EMPTY
   padding, every 97th row empty, 1% negative ids, positive weights) as
   padded-dense ids, SparseIds and RaggedIds, through
   embedding_lookup_sparse and safe_embedding_lookup_sparse (with and
   without default_id) for sum, mean and sqrtn, each followed by
   apply_sparse_gradients, on the card and on a CPU copy: key planes and
   scores bit-exact after every step, combined outputs, row gradients
   and rows within rtol 1e-5 / atol 1e-6. (d) Each family's run_demo
   with the JAX package's test seeds and sizes, held to the JAX tests'
   bars (MovieLens eval MSE < 1.0, multi-hot < 2.0, retrieval recall >
   0.8, DCN AUC > 0.6, seq-and-dense eval MSE < 0.5). (e) DLRM-DCNv2
   at MLPerf Training's published widths (DLRMDCNv2Config(): dim 128,
   26 sum-pooled bags of MLPerf's sizes, 214 ids an example, bottom
   13-512-256-128, 3 low-rank crosses of 3,456 x 512, over arch
   3456-1024-1024-512-256-1; a 4Mi-slot table with its Adagrad
   accumulator, rows of 1 KiB): 3 steps of 8,192 examples (1,753,088
   positions, ~850k distinct keys; batches 0, 1, 1: an empty table's
   inserts, the miss branch, the all-hit branch) with the launch counts
   set to 0 just before (row_gather, fused_update_scatter and init_rows
   must launch), the losses finite; then one more step on a new batch
   and that batch again (the lookup's miss and all-hit branches), each
   step's own calls of row_gather (bit-exact), fused_update_scatter (4
   f32 ulps) and, on the miss step, init_rows (bit-exact) against their
   plain versions.
7. The table lifecycle, launch counts reset first (row_gather,
   row_scatter and fused_update_scatter must launch). (a) DLRMConfig()
   trains 20 steps of 4096; DECheckpoint saves its table, towers and
   tower optimizer state, and a fresh DLRM restores them: the per-key
   export (keys, value and slot words, scores) bit-equal, the towers
   and optimizer state equal, 3 more steps from both with losses within
   rtol 1e-6 (the largest gap printed), and the table's files written
   from the card byte-identical to those written from a CPU copy. (b) A
   table of the table step's width (dim 64, 2Mi slots, Adam slots, 1 KiB
   rows) filled by import_batch with 1.5Mi keys and int32 scores from a
   seeded permutation with ties: TimestampRestrictPolicy on an LRU view
   and FrequencyRestrictPolicy on an LFU view down to 1Mi keys, the
   survivors exactly numpy's top by (score, slot); lowest_k_indices of
   100,000 against numpy. (c) grow to 4Mi slots: every key's value, slot
   rows and score bit-equal, and a lookup of all of them finds them.
   (d) export_chunked in 1Mi-slot chunks equals the export. Save and
   restore ms, GB written, keys/s, restrict, grow and export ms.
8. The sharded table (``parallel/``) on a mesh of 4 logical shards of
   the card (``create_mesh(devices=[cuda] * 4)``). (a) DLRMConfig() with
   ``mesh=``: 4 shards of 1Mi slots with their Adagrad accumulator; 20
   steps of 4096 through train_loop (the ``sharded_training`` path:
   row_gather and fused_update_scatter must launch), the loss finite and
   lower at step 20; ms/step, examples/s, host syncs a step (all, and the
   routing's own), the dropped keys summed, the live keys per shard, and
   the exchange's share of the device time of 3 steps (its
   torch.profiler range). (b) The same seed, 3 steps sharded and
   unsharded: the same live keys, per-key rows within rtol 1e-5 / atol
   1e-6, the loss gap. (c) tests/test_sharded.py's hot-key batch scaled
   to 4096 ids: block 0 one key 1024 times (K = 512): every step takes
   the dedup retry and drops nothing; rows agree with one table. (d) The
   narrow DLRM on 4 shards of the card and of the CPU: send_pos, routed,
   found, inserted, the owners' keys and every shard's key and score
   planes bit-exact, rows within rtol 1e-5 / atol 1e-6. (e) NCCL, a world
   of one rank (a FileStore in a temporary directory), S = 1: 3 DLRM
   steps per key against (b)'s unsharded table, and whether they are
   bit-equal. (f) (a)'s table saved as 4 shard file sets and restored
   into 4 shards (the direct path) and into one table, every key's rows,
   slots and score bit-equal (the ``sharded_checkpoint`` path: row_gather
   and row_scatter must launch).
9. The spill tier (ops/spill.py, native/, serving/kv.py). The native
   host store is built with g++ in a thread beside the nvcc builds (its
   seconds reported). DLRM's table, Variable(dim=64, init_capacity=4Mi,
   LRU, float32) with its Adagrad slot created first (rows of 512 B),
   under HybridTable(0.95, 0.80), with 8Mi distinct keys from the seed.
   (a) Every key through HybridTable.upsert in blocks of 65,536 (rows a
   function of the key and the seed): total_keys is 8Mi, the card's and
   the tier's key sets are disjoint and together the keys, every row is
   its key's value bit for bit; ms, rows absorbed, host GB/s. (b) 20
   steps of 65,536 zipf(1.2) ids over a seeded permutation of the keys:
   promote, demote_to_watermark, embedding_lookup and the tier's Adagrad
   apply, each step's promote, demote and lookup+apply ms, rows moved,
   batch keys still missing after the watermark, host syncs, GB/s; the
   first step's demote row gather and promote row scatter held against
   their plain versions (bit-exact); the time of promote's Python loop at
   a batch's unique keys. (c) The same sequence at dim 8, 4,096 slots
   and 16Ki keys on the card and on the CPU: key planes, scores, the
   stores' keys and scores and the SpillStats bit-exact, trained rows
   within rtol 1e-5 / atol 1e-6 (the grad combine's f64 prefix sums run
   in another order on the card). (d) save_dynamic_embedding(...,
   tier=hy) and a cold restore into a fresh HybridTable: every key of
   each tier bit-equal (rows, score, slot); save and restore ms and GB
   of each tier. (e) lookup_through of 65,536 ids (card hits, tier hits,
   unknown keys) and EmbeddingServer(tiers=) over freeze(float32), 8
   checked and 16 timed requests of 256 x 26 ids, each bit-equal to a
   numpy reference built from the two tiers' exports. (f) A
   ShardedSpillTier on 4 logical shards of the card: (a)'s prefill and
   5 steps; and a SpillTier over a RemoteKVStore on an in-process
   HostKVServer against one over a local store, 65,536 rows demoted and
   promoted, planes and stores bit-equal, us per row. Launch counts are
   reset before each part; row_gather and row_scatter must launch on
   each, fused_update_scatter on (b) and the sharded (f).
10. The row-copy micro-benchmark (recommenders_addons_tpu_torch/tools/
   dma_bench.py) at its two full-width shapes, 2Mi rows of 2 chunks (its
   default) and 4Mi rows of 1: every variant of its two lists, a
   predicated gather (row and premultiplied predicate) and a predicated
   scatter, each bit-exact against its plain version on random words at
   N = 66,573 with sentinel, negative and past-the-end indices; the
   gathers also where their pipelines turn: rows of 128 KiB (ch = 256, a
   64-row table, N = 1,037 and 2,051) and N = 2^18 + 3 (ch = 2), where
   every block wraps its ring of stages many times; then the tool's
   main() at both shapes (ns/row slopes, ms per 65,536-row call, bytes
   bounds, beside row_gather/row_scatter and index_select /
   index_copy_); then its four kernels' plain versions timed, and the two
   gathers' ms over their bound and over index_select, with a
   torch.profiler trace of 10 calls each (device busy share, kernel ms).
11. The two probes (recommenders_addons_tpu_torch/tools/ab_kernel_cost.py
   and ab_radix_plan.py). ab_fused against its plain version at the
   fused-apply probe's full width (2Mi rows of 1 KiB, N = 66,573 unique
   indices, v >= 0), every mode x sub x nbuf: identity and rawcopy
   bit-exact, Adam's updated words within 4 ulps, its pad columns +0.0,
   rows it does not write bit-exact; once more on the probe's own
   standard-normal inputs (v < 0), where the NaN positions must agree.
   radix_hist against torch.bincount, bit-exact, on 65,536 bucket ids of
   the 2Mi table, on a ragged N with negative and >= 1024 ids (also
   starting off a 16-byte boundary) and on 4,194,304 bucket ids; then
   tools/hist_bench.py times it at 8,192, 65,536 and 4,194,304 ids beside
   an empty kernel (the launch floor) and counts its device operations
   per call: the nodes of a CUDA graph captured from one call must be one
   kernel and nothing else, at each N (a torch.profiler count, which
   drops events now and then, is reported beside it). Each kernel timed
   beside its plain version (and torch.bincount); then each tool's main()
   (ns/row of its five variants; ns/key of its four).

12. The 64-bit and bool value dtypes at the table step's width (dim 64,
   2Mi slots): an f64 table with its Adam slots (rows of 2 KiB), an int64
   table (1 KiB) and a bool table (128 B). (a) Each filled with 1Mi keys
   in blocks of 65,536 (size 1Mi); (b) every key and 65,536 misses
   looked up, each row bit-equal to the values put, misses zero; 64-bit
   rows through row_scatter and row_gather (a view of two words an
   element, ch doubled), bool rows by torch indexing (no kernel). (c)
   10 Adam steps of 65,536 zipf(1.2) ids (a tenth new keys) on the f64
   table (unfused: row_gather, row_scatter, no fused_update_scatter)
   and on an f32 table of the same shape (fused), ms/step of both. (d)
   A 64Ki-slot f64 table, normal(0.05) initial rows, 5 Adam steps of
   8,192 ids on the card and on the CPU: key planes and scores
   bit-exact, rows within rtol 1e-12. (e) Each table saved from the
   card and from a CPU copy, the files byte-identical, and restored on
   the card, per key bit-equal. (f) row_gather and row_scatter on the
   last f64 step's own operands against their plain versions,
   bit-exact (row_scatter on rows [0, C)), timed beside them, the
   library call and the bytes bound (row_scatter's as in phase 1).
13. The input pipeline: a Criteo-format file of 40 x 4,096 lines (about
   30 MB, a learnable hot token) from the seed; CriteoTSVReader's rows/s
   alone; examples/dlrm_train.main at DLRMConfig() width (dim 64, batch
   4096) for 30 steps from the file through prefetch (row_gather and
   fused_update_scatter must launch, the final loss finite), beside the
   same on the synthetic batches: ms/step of both from the examples/s
   line; the same example at the JAX test's size (2,000 lines, 60
   steps, batch 256, dim 8): AUC above 0.8; examples/movielens_train on
   4,000 fabricated ratings: eval MSE below 0.8; utils.profiling.trace
   around 3 reader-fed DLRM steps: the Chrome trace holds row_gather's
   and the fused apply's kernels and the annotate range; StepTimer's
   mean beside CUDA events of 5 more steps.
14. The other seven examples' main() at their own defaults on the card:
   each returns 0 and prints its JAX counterpart's result lines.

Each main path (serving, the gRPC handler, DLRM training, table step,
the optax adapter, the named Adam beside it, the sharded adapter, the
five parts of
the training surface, the DCN, the sparse API, the learning bars,
DLRM-DCNv2, the lifecycle, sharded training, the sharded checkpoint, the six parts of
the spill phase, the dtypes phase's fills, lookups, f64 training and
checkpoints, the data phase's five runs, each example, dma_bench,
ab_kernel_cost, ab_radix_plan) is driven with the kernels' launch
counts set to 0 just before it and read just after; a kernel of the
path that was not launched fails the run.

Output: the card's name and power limit on a line of its own,
``{"serving": ...}`` (its ``grpc`` part inside), ``{"training": ...}``,
``{"optax": ...}``, ``{"training_surface": ...}``, ``{"models": ...}``, ``{"lifecycle": ...}``,
``{"sharded": ...}``, ``{"spill": ...}``, ``{"dtypes": ...}``,
``{"data": ...}``, ``{"examples": ...}``, ``{"dma_bench": ...}``,
``{"ab_tools": ...}``, ``{"kernels": [...]}`` and last
``{"ok": true, "device": {...}}``. Each phase's own seconds are in its
line (``phase_s``).
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

C = 1 << 22  # DLRMConfig.table_capacity
DIM = 64  # DLRMConfig.dim
FEATURES = 26  # DLRMConfig.num_sparse
IDS_PER_FEATURE = 80_658  # 26 * 80,658 = 2,097,108 keys: load cap -> 4Mi
FEATURE_SHIFT = 56  # models/dlrm.py tag_keys: top byte = feature id
KEY_MASK = (1 << 56) - 1
VOCAB = 100_000  # synthetic_criteo_batch vocab_per_feature
N_GATHER = 65536
N_SCATTER = 1 << 20
LANES = 128
DLRM_BATCH = 4096  # bench.py's DLRM batch: 4096 x 26 = 106,496 keys
DLRM_STEPS = 20
TABLE_CAP = 1 << 21  # bench.py CAP
TABLE_N = 65536  # bench.py's larger batch
# the training_surface phase: deferred zipf steps, bp_v2 steps, fresh ids
# crowded into one bucket (more than its 64 slots, so some are dropped),
# the import size, and tests/test_torch_training_surface.py's f32
# tolerance for rows trained two ways
SURFACE_STEPS = 10
SURFACE_BP_STEPS = 5
SURFACE_CROWD = 100
SURFACE_IMPORT_N = 1 << 20
SURFACE_RTOL, SURFACE_ATOL = 1e-5, 1e-6
# tools/dma_bench.py: its default (2Mi rows of 1 KiB, bench.py's CAP and
# table-step row) and kernel 1's serving shape (4Mi rows of 512 B)
DMA_SHAPES = ((21, 2), (22, 1))
DMA_N_CHECK = 65536 + 1037  # ragged: a partial tile and group
# the gathers' pipeline turns: (table rows, ch, N)
DMA_PIPE_CHECKS = ((64, 256, 1037), (64, 256, (1 << 11) + 3),
                   (1 << 12, 2, (1 << 18) + 3))
AB_N_CHECK = 65536 + 1037  # ragged: a partial tile and chunk
AB_STEP = 3.0
HIST_N_BIG = 1 << 22  # radix_hist over a grid of many clusters
# the models phase: DCNConfig()'s 20 steps; the narrow DLRM's and DCN's
# card-against-CPU tolerance for losses and rows (matrix products sum in
# another order on the card); the sparse API's 8,192 rows of up to 8 ids
# at DCN's table width, in a table of 256Ki slots, held card against CPU
# at the training tests' f32 tolerance
DCN_STEPS = 20
NARROW_RTOL, NARROW_ATOL = 1e-4, 1e-5
SHARDS = 4  # the sharded phase's logical shards of the card
SHARD_CHECK_STEPS = 3
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6  # tests/test_sharded.py:110-113
SPARSE_ROWS, SPARSE_LEN, SPARSE_CAP = 8192, 8, 1 << 18
# the models phase's DLRM-DCNv2 at MLPerf's published widths: the
# benchmark cell's 8,192 examples of 214 ids (1,753,088 positions), each
# bag's first id zipf(1.1) over 1Mi ids a feature and the rest a fixed
# function of it, as MLPerf's Multihot builds bags (~850k distinct keys a
# batch), in a table of 4Mi slots; main-path steps on batches 0, 1, 1
DCNV2_BATCH, DCNV2_ZIPF, DCNV2_VOCAB, DCNV2_CAP = 8192, 1.1, 1 << 20, 1 << 22
DCNV2_PLAN = (0, 1, 1)
# the lifecycle phase: DLRM's steps before the checkpoint and after the
# restore (losses of the two within LIFE_LOSS_RTOL); a table of the table
# step's width filled with LIFE_N keys, restricted to LIFE_RESERVED,
# grown to LIFE_GROW slots and exported in LIFE_SPLIT-slot chunks
LIFE_DLRM_STEPS, LIFE_EXTRA_STEPS, LIFE_LOSS_RTOL = 20, 3, 1e-6
LIFE_CAP, LIFE_N, LIFE_RESERVED = 1 << 21, 3 << 19, 1 << 20
LIFE_GROW, LIFE_SPLIT, LIFE_LOWEST_K = 1 << 22, 1 << 20, 100_000
# the spill phase: DLRM's table under a HybridTable with twice its
# capacity in keys, upserted in blocks; training batches of zipf ids;
# the sharded tier's steps; serving requests checked and timed; the
# narrow card-against-CPU run (dim, slots, keys); the networked store's
# table and its demoted rows
SPILL_KEYS, SPILL_BLOCK, SPILL_BATCH = 1 << 23, 65536, 65536
SPILL_STEPS, SPILL_SHARDED_STEPS = 20, 5
SPILL_HIGH, SPILL_LOW = 0.95, 0.80
SPILL_REQUESTS, SPILL_TIMED = 8, 16
# the serving phase's gRPC part: requests checked and timed
GRPC_CHECKED, GRPC_TIMED = 8, 16
SPILL_NARROW = (8, 1 << 12, 1 << 14)
SPILL_REMOTE_CAP, SPILL_REMOTE_N = 1 << 18, 65536
# the dtypes phase: the table step's width (dim 64, 2Mi slots, Adam) as
# f64 (rows of 2 KiB), int64 (1 KiB) and bool (128 B) tables filled with
# DT_KEYS keys in blocks of DT_BLOCK; DT_STEPS training steps; the
# narrow f64 table trained on the card and the CPU, rows within
# DT_NARROW_RTOL (the combine's additions may run in another order)
DT_CAP, DT_DIM, DT_KEYS, DT_BLOCK = TABLE_CAP, 64, 1 << 20, 65536
DT_STEPS = 10
DT_NARROW_CAP, DT_NARROW_STEPS, DT_NARROW_BATCH = 1 << 16, 5, 8192
DT_NARROW_RTOL = 1e-12
# the optax phase: the adapter at the table step's width (dim 64, 2Mi
# slots, 1 KiB rows with Adam's three state columns), zipf ids from a
# universe of 1Mi keys so that nothing is evicted; its warm and timed
# steps and the profiled ones; (b) the narrow card-against-CPU run (dim,
# slots, steps, batch, universe); (c) the sharded steps
OPTAX_UNIVERSE, OPTAX_WARM, OPTAX_TIMED, OPTAX_PROFILED = 1 << 20, 2, 10, 3
OPTAX_NARROW = (8, 1 << 12, 5, 1024, 2048)
OPTAX_SHARD_STEPS = 3
# the data phase: a Criteo-format file of DATA_LINES lines (about 30 MB),
# the reader-fed full-width DLRM's steps, the steps traced and timed
DATA_LINES, DATA_STEPS = 40 * 4096, 30
DATA_PROFILE_STEPS, DATA_TIMER_STEPS = 3, 5

_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations per updated column of Adagrad (ops/optimizer.py:
# g*g, +, sqrt, +, lr*g, /, -), for the fused kernel's operations bound
_ADAGRAD_FLOPS = 7
# ... and of the probe's adam_tile: m (2 *, +), v (3 *, +), the value
# (sqrt, +, *, /, -)
_ADAM_FLOPS = 12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after two
    warm-up calls: CUDA events behind a device spin that lets the host
    queue every launch first (dma_bench.seconds), so host launch gaps
    between short kernels are not counted."""
    from recommenders_addons_tpu_torch.tools.dma_bench import seconds

    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    return seconds(calls, torch.device("cuda"), iters) / iters * 1e3


def _device_profile(torch, fn, iters: int = 10, top_n: int = 5):
    """Device busy share of ``iters`` back-to-back calls of ``fn`` (kernel
    time summed from a torch.profiler trace over the host wall time) and
    the ``top_n`` kernels that took the most device time, in ms per call.
    Returns (None, []) when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [(e.key, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(us for _, us in kernels)
    if busy_us == 0:
        return None, []
    top = sorted(kernels, key=lambda kv: -kv[1])[:top_n]
    return busy_us / wall_us, [[k[:80], us / iters / 1e3] for k, us in top]


def _same_bits(torch, a, b) -> int:
    """Max |difference| of two 32-bit tensors' int32 words (0 = equal)."""
    a, b = a.view(torch.int32), b.view(torch.int32)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    ne = a != b
    if not bool(ne.any()):
        return 0
    return int((a[ne].to(torch.int64) - b[ne].to(torch.int64)).abs().max())


def _tag_keys(ids: np.ndarray) -> np.ndarray:
    """[B, F] raw ids -> feature-tagged keys (models/dlrm.py tag_keys)."""
    f = np.arange(ids.shape[-1], dtype=np.int64)
    return (ids.astype(np.int64) & KEY_MASK) | (f << FEATURE_SHIFT)


def kernel_phase(torch, cuda_ops, dev, gen, rate):
    """Phase 1: each kernel against its plain version; timings."""
    from recommenders_addons_tpu_torch.tools import row_sweep

    i32 = torch.int32
    cap_words = (-(1 << 31), (1 << 31) - 1)
    results = []

    # -- row_gather at the serving shape: C = 4Mi, ch = vc = 1 ------------
    table = torch.randint(*cap_words, ((C + 1), LANES), dtype=i32,
                          device=dev, generator=gen).view(torch.float32)
    idx = torch.randint(0, C, (N_GATHER,), dtype=i32, device=dev,
                        generator=gen)
    idx[::97] = C  # sentinel misses read the trash row
    err = _same_bits(torch,
                     cuda_ops.gather_rows_2d(table, 1, idx, masked=False),
                     cuda_ops.gather_rows_2d_plain(table, 1, idx,
                                                   masked=False))
    # ragged N with sentinel, negative and past-the-end indices
    rag = torch.randint(0, C, (1037,), dtype=i32, device=dev, generator=gen)
    rag[::7], rag[3::11], rag[5::13] = C, -1, C + 9
    for kw in (dict(cap=C, masked=True), dict(cap=C, flat=True)):
        err = max(err, _same_bits(
            torch, cuda_ops.gather_rows_2d(table, 1, rag, **kw),
            cuda_ops.gather_rows_2d_plain(table, 1, rag, **kw)))
    # ch = 2 table (value + slot chunk), whole rows and the vc = 1 stride
    c2 = 1 << 20
    t2 = torch.randint(*cap_words, ((c2 + 1) * 2, LANES), dtype=i32,
                       device=dev, generator=gen).view(torch.float32)
    i2 = torch.randint(0, c2 + 1, (N_GATHER,), dtype=i32, device=dev,
                       generator=gen)
    for vc in (1, 2):
        err = max(err, _same_bits(
            torch, cuda_ops.gather_rows_2d(t2, 2, i2, masked=False, vc=vc),
            cuda_ops.gather_rows_2d_plain(t2, 2, i2, masked=False, vc=vc)))
    del t2, i2
    torch.cuda.synchronize()
    g_ms = _time_ms(torch, lambda: cuda_ops.gather_rows_2d(
        table, 1, idx, masked=False), 50)
    g_plain = _time_ms(torch, lambda: cuda_ops.gather_rows_2d_plain(
        table, 1, idx, masked=False), 20)
    g_lib = _time_ms(torch, lambda: torch.index_select(table, 0, idx), 50)
    rows_read = int(torch.unique(idx).numel())
    g_bytes = rows_read * 512 + N_GATHER * 4 + N_GATHER * 512
    results.append({
        "name": "row_gather", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/row_gather.cu",
        "replaces": "recommenders_addons_tpu/ops/pallas_ops.py:165",
        "replaces_fn": "_gather_kernel via gather_rows_2d",
        "max_abs_err": err, "match": err == 0,
        "ms": g_ms, "kernel_ms": g_ms, "plain_ms": g_plain,
        "library_ms": g_lib, "library_call": "torch.index_select",
        "bound_ms": g_bytes / rate * 1e3, "bound_by": "bytes",
        "bytes": g_bytes, "shape": f"C={C} ch=1 vc=1 N={N_GATHER}",
    })

    # -- row_scatter at the load shape: 1Mi unique rows plus sentinels ----
    sidx = torch.randperm(C, device=dev, generator=gen)[:N_SCATTER].to(i32)
    sidx[::64] = C  # sentinels land on the trash row
    rows = torch.randint(*cap_words, (N_SCATTER, LANES), dtype=i32,
                         device=dev, generator=gen).view(torch.float32)
    a = table.clone()
    cuda_ops.scatter_rows_set_2d(a, 1, sidx, rows, cap=C)
    cuda_ops.scatter_rows_set_2d_plain(table, 1, sidx, rows, cap=C)
    s_err = _same_bits(torch, a[:C], table[:C])  # never the trash row
    del a
    safe = torch.where((sidx >= 0) & (sidx < C), sidx, C).long()
    s_ms = _time_ms(torch, lambda: cuda_ops.scatter_rows_set_2d(
        table, 1, sidx, rows, cap=C), 20)
    s_plain = _time_ms(torch, lambda: cuda_ops.scatter_rows_set_2d_plain(
        table, 1, sidx, rows, cap=C), 10)
    s_lib = _time_ms(torch, lambda: table.index_copy_(0, safe, rows), 20)
    # the bound counts each valid row read and written once, plus the
    # indices; the count every input row read is kept beside it
    s_inp = row_sweep.ScatterInput(dict(table2d=table, ch=1, idx=sidx,
                                        rows=rows, cap=C))
    s_bytes = row_sweep.scatter_bytes(s_inp)
    s_old = row_sweep.scatter_bytes_every_row(s_inp)
    del s_inp
    results.append({
        "name": "row_scatter", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/row_scatter.cu",
        "replaces": "recommenders_addons_tpu/ops/pallas_ops.py:192",
        "replaces_fn": "_scatter_kernel via scatter_rows_set_2d",
        "max_abs_err": s_err, "match": s_err == 0,
        "ms": s_ms, "kernel_ms": s_ms, "plain_ms": s_plain,
        "library_ms": s_lib, "library_call": "torch.Tensor.index_copy_",
        "bound_ms": s_bytes / rate * 1e3, "bound_by": "bytes",
        "bytes": s_bytes, "old_bound_ms": s_old / rate * 1e3,
        "old_bytes": s_old, "shape": f"C={C} ch=1 N={N_SCATTER}",
        "trash_share": 1.0 - float(((sidx >= 0) & (sidx < C)).float()
                                   .mean()),
    })
    del table, rows, safe, sidx
    torch.cuda.empty_cache()
    bad = [r["name"] for r in results if not r["match"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return results


def _init_rows_call(torch, dev, gen, dt, n_new=130):
    """init_rows' operands as one uniform-warm DLRM step hands them over
    (see the module docstring); returns (args, not-found count)."""
    from recommenders_addons_tpu_torch.ops import hashing, initializers, prng

    n = DLRM_BATCH * 2 * FEATURES
    keys = torch.randint(0, 150_000, (n,), device=dev, generator=gen)
    keys = keys * 0x9E3779B1 + (1 << 40)
    _, inv = torch.unique(keys, return_inverse=True)
    pos = torch.arange(n, device=dev)
    first = torch.full((int(inv.max()) + 1,), n, device=dev).scatter_reduce(
        0, inv, pos, "amin")
    rep = torch.zeros(n, dtype=torch.bool, device=dev)
    rep[first] = True
    inserted = torch.zeros_like(rep)
    inserted[first[torch.randperm(first.numel(), device=dev,
                                  generator=gen)[:n_new]]] = True
    found = rep & ~inserted
    uniq = torch.where(rep, keys, hashing.EMPTY_KEY)
    w = LANES * (2 if dt == torch.bfloat16 else 1)
    rows = torch.randint(-(1 << 31), (1 << 31) - 1, (n, LANES),
                         dtype=torch.int32, device=dev,
                         generator=gen).view(dt).reshape(n, w)
    fresh = torch.zeros(w - DIM, dtype=dt, device=dev)
    fresh[:DIM] = 0.1  # the Adagrad slot's initial accumulator
    args = (rows, uniq, found, inserted, prng.PRNGKey(7, device=dev),
            initializers.uniform(0.05), DIM, fresh)
    return args, int((~found).sum())


def _init_rows_kernel(torch, cuda_ops, dev, gen, rate):
    """Kernel 10 against its plain version at one DLRM step's own call,
    f32 and bf16; then the launches of a miss-branch and an all-hit
    lookup."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.ops import initializers
    from recommenders_addons_tpu_torch.tools.fused_sweep import max_ulps

    out = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args, not_found = _init_rows_call(torch, dev, gen, dt)
        rows, rest = args[0], args[1:]
        got = rows.clone()
        cuda_ops.init_rows(got, *rest)
        cuda_ops.init_rows_plain(rows, *rest)
        err = _same_bits(torch, got.view(torch.int32), rows.view(torch.int32))
        nrm = rest[:4] + (initializers.normal(0.05),) + rest[5:]
        a, b = rows.clone(), rows.clone()
        cuda_ops.init_rows(a, *nrm)
        cuda_ops.init_rows_plain(b, *nrm)
        ulps = max_ulps(a, b, 32 if dt == torch.float32 else 16)
        del a, b
        ms = _time_ms(torch, lambda: cuda_ops.init_rows(got, *rest), 50)
        plain_ms = _time_ms(torch, lambda: cuda_ops.init_rows_plain(
            rows, *rest), 5)
        n, w = rows.shape
        esize = rows.element_size()
        n_ins = int(rest[2].sum())
        nbytes = (n * (rest[0].element_size() + 2)
                  + not_found * DIM * esize + n_ins * (w - DIM) * esize)
        out[tag] = {"max_abs_err": err, "normal_max_ulps": ulps, "ms": ms,
                    "plain_ms": plain_ms, "bytes": nbytes,
                    "bound_ms": nbytes / rate * 1e3, "not_found": not_found,
                    "inserted": n_ins, "shape": f"N={n} W={w} D={DIM}"}
        if err or ulps > (4 if dt == torch.float32 else 1):
            raise AssertionError(f"init_rows {tag} disagrees with its plain "
                                 f"version: {out[tag]}")
        del rows, got, args, rest, nrm
        torch.cuda.empty_cache()

    var = de.Variable(name="init_rows_smoke", dim=DIM, init_capacity=1 << 16,
                      initializer=de.initializers.uniform(0.05))
    st = de.create_slots(var, var.init(), de.Adagrad(0.01))
    keys = torch.randint(1, 1 << 40, (DLRM_BATCH,), device=dev,
                         generator=gen)
    seen = {}
    for what, batch in (("miss", keys), ("hit", keys)):
        cuda_ops.reset_launches()
        _, ctx = var.embedding_lookup(st, batch, step=1)
        st = var.apply_gradients(st, ctx, torch.zeros(
            (batch.numel(), DIM), device=dev), de.Adagrad(0.01), step=1)
        seen[what] = cuda_ops.INIT_ROWS.launches
    if seen != {"miss": 1, "hit": 0}:
        raise AssertionError(f"init_rows launches by lookup branch: {seen} "
                             f"(want one on the miss branch, none on hits)")
    f32 = out["f32"]
    return {
        "name": "init_rows", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/init_rows.cu",
        "replaces": "none (XLA's threefry in the JAX package's "
                    "plan_lookup_train; the port's torch threefry)",
        "replaces_fn": "materialize_rows + blend in "
                       "hashtable.plan_lookup_train's miss branch",
        "max_abs_err": max(o["max_abs_err"] for o in out.values()),
        "match": True, "ms": f32["ms"], "kernel_ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "library_ms": None,
        "library_call": "none (no PyTorch call draws threefry rows)",
        "bound_ms": f32["bound_ms"], "bound_by": "bytes",
        "bytes": f32["bytes"], "shape": f32["shape"],
        "dlrm_step_f32": f32, "dlrm_step_bf16_phys": out["bf16"],
        "lookup_launches": seen,
    }


def serving_phase(torch, cuda_ops, dev, gen, seed):
    """Phase 2: the port's serving path, end to end, on the card."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.serving import (
        EmbeddingClient,
        serve_directory,
    )

    ids = np.arange(IDS_PER_FEATURE, dtype=np.int64)
    keys_np = _tag_keys(np.broadcast_to(ids[:, None], (IDS_PER_FEATURE,
                                                       FEATURES))).reshape(-1)
    n_keys = keys_np.shape[0]
    keys = torch.from_numpy(keys_np).to(dev)
    values = torch.randn((n_keys, DIM), device=dev, generator=gen)

    var = de.Variable(name="dlrm_shared", dim=DIM, init_capacity=C)
    state = var.init()
    t0 = time.perf_counter()
    for off in range(0, n_keys, 1 << 20):
        state = var.upsert(state, keys[off:off + (1 << 20)],
                           values[off:off + (1 << 20)])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if int(var.size(state)) != n_keys:
        raise AssertionError(f"table holds {int(var.size(state))} of "
                             f"{n_keys} keys")

    # independent reference: sorted keys, numpy's own f16 rounding
    order = np.argsort(keys_np, kind="stable")
    ref_keys = keys_np[order]
    ref_vals = values.cpu().numpy()[order].astype(np.float16)
    del values

    def reference(q):
        pos = np.minimum(np.searchsorted(ref_keys, q), n_keys - 1)
        hit = ref_keys[pos] == q
        vals = np.where(hit[:, None], ref_vals[pos].astype(np.float32), 0.0)
        return vals.astype(np.float32), hit

    rng = np.random.default_rng(seed)
    reqs = [_tag_keys(rng.zipf(1.2, size=(256, FEATURES)) % VOCAB
                      ).reshape(-1) for _ in range(8)]

    with tempfile.TemporaryDirectory() as d:
        de.serving.export_compressed(var, state, d, dtype=torch.float16)
        del state
        torch.cuda.empty_cache()

        # -- the main path: counters from 0, serve, answer, read counters --
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        srv = serve_directory(d, port=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        answers, lat = {}, {}
        with srv:
            cli = EmbeddingClient(srv.host, srv.port, timeout=120)

            def ask(i):
                t = time.perf_counter()
                answers[i] = cli.lookup("dlrm_shared", reqs[i])
                lat[i] = time.perf_counter() - t

            for i in range(4):
                ask(i)
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(4, 8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                if t.is_alive():
                    raise AssertionError("a concurrent request hung")
            launches = {k.name: k.launches for k in cuda_ops.KERNELS}
            table = srv._entries["dlrm_shared"].table
            if table.spec.capacity != C or table.size() != n_keys:
                raise AssertionError(
                    f"served table: capacity {table.spec.capacity}, "
                    f"{table.size()} keys")

            misses = 0
            for i, q in enumerate(reqs):
                vals, found = answers[i]
                want_vals, want_found = reference(q)
                if vals.shape != (q.shape[0], DIM):
                    raise AssertionError(f"request {i}: shape {vals.shape}")
                if not np.isfinite(vals).all():
                    raise AssertionError(f"request {i}: non-finite values")
                if not np.array_equal(found, want_found):
                    raise AssertionError(f"request {i}: found differs")
                if not np.array_equal(vals.view(np.int32),
                                      want_vals.view(np.int32)):
                    raise AssertionError(f"request {i}: values differ")
                misses += int((~found).sum())
            n_ids = sum(r.shape[0] for r in reqs)
            if not 0 < misses < n_ids:
                raise AssertionError(f"{misses} misses of {n_ids} ids: the "
                                     f"requests should hit and miss")
            if not (launches["row_gather"] and launches["row_scatter"]):
                raise AssertionError(
                    f"a kernel was not launched on the serving path: "
                    f"{launches}")

            # -- timings after the checked run --------------------------
            q = torch.from_numpy(_tag_keys(
                rng.zipf(1.2, size=(N_GATHER // FEATURES + 1, FEATURES))
                % VOCAB).reshape(-1)[:N_GATHER]).to(dev)
            lookup_ms = _time_ms(torch, lambda: table.lookup(q), 20)
            busy, top = _device_profile(torch, lambda: table.lookup(q))
            seq, ent = [], []
            for i in range(16):
                t = time.perf_counter()
                cli.lookup("dlrm_shared", reqs[i % 8])
                seq.append(time.perf_counter() - t)
                # the server's table layer alone: pad, copy in, probe,
                # gather, copy out (what one request's batch costs it)
                t = time.perf_counter()
                srv._entries["dlrm_shared"].lookup(reqs[i % 8])
                ent.append(time.perf_counter() - t)

            grpc = _grpc_handler_part(torch, cuda_ops, srv, reqs, answers,
                                      reference)

    seq_ms = sorted(s * 1e3 for s in seq)
    ent_ms = sorted(s * 1e3 for s in ent)
    return {
        "keys": n_keys, "capacity": C, "dim": DIM, "stored": "float16",
        "fill_upsert_s": fill_s, "load_compressed_s": load_s,
        "requests": len(reqs), "ids_per_request": int(reqs[0].shape[0]),
        "concurrent": 4, "ids": n_ids, "misses": misses,
        "exact": True, "launches": launches,
        "request_ms_p50": seq_ms[len(seq_ms) // 2],
        "request_ms_max": seq_ms[-1], "request_samples": len(seq_ms),
        "table_entry_ms_p50": ent_ms[len(ent_ms) // 2],
        "table_entry_ms_max": ent_ms[-1],
        "checked_request_ms": [lat[i] * 1e3 for i in range(8)],
        "lookup_n": N_GATHER, "lookup_ms": lookup_ms,
        "lookup_keys_per_s": N_GATHER / (lookup_ms / 1e3),
        "lookup_device_busy_share": busy,
        "lookup_top_kernels_ms": top,
        "grpc": grpc,
    }


def _grpc_handler_part(torch, cuda_ops, srv, reqs, answers, reference):
    """The gRPC front end's Lookup on the served table, without its
    transport (the smoke imports no grpc): each request packed,
    passed through ``grpc_server.lookup_bytes`` (the servicer's body:
    the codec, the server's ``_Batcher`` and ``FrozenTable.lookup``, so
    row_gather) and unpacked. GRPC_CHECKED requests held bit-equal to the
    numpy reference, their response bytes equal to the codec's packing
    of the HTTP client's answer to the same ids; then GRPC_TIMED timed
    (host clock), with the codec's own time: the client's pack and
    unpack inside the timed call, the server's unpack and pack of the
    same bytes timed after it."""
    import importlib.util

    from recommenders_addons_tpu_torch.serving import grpc_server as g

    name = "dlrm_shared"
    cuda_ops.reset_launches()
    for i in range(GRPC_CHECKED):
        resp = g.lookup_bytes(srv._batchers, g._pack_lookup_request(
            name, reqs[i]))
        vals, found = g._unpack_lookup_response(resp)
        want_vals, want_found = reference(reqs[i])
        if not (np.array_equal(found, want_found)
                and np.array_equal(vals.view(np.int32),
                                   want_vals.view(np.int32))):
            raise AssertionError(f"gRPC request {i}: the answer differs "
                                 f"from the numpy reference")
        if resp != g._pack_lookup_response(*answers[i]):
            raise AssertionError(f"gRPC request {i}: the response bytes "
                                 f"differ from the HTTP answer's")
    try:
        g.lookup_bytes(srv._batchers, g._pack_lookup_request("nope",
                                                             reqs[0]))
        raise AssertionError("an unknown table was answered")
    except g.UnknownTableError:
        pass
    total, codec = [], []
    for i in range(GRPC_TIMED):
        q = reqs[i % len(reqs)]
        t = time.perf_counter()
        req = g._pack_lookup_request(name, q)
        t1 = time.perf_counter()
        resp = g.lookup_bytes(srv._batchers, req)
        t2 = time.perf_counter()
        g._unpack_lookup_response(resp)
        t3 = time.perf_counter()
        _, ids = g._unpack_lookup_request(req)
        g._pack_lookup_response(*g._unpack_lookup_response(resp))
        t4 = time.perf_counter()
        total.append((t3 - t) * 1e3)
        codec.append(((t1 - t) + (t3 - t2) + (t4 - t3)) * 1e3)
    launches = _launched(cuda_ops, "grpc", ("row_gather",),
                         phase="serving")
    order = np.argsort(total)
    p50 = int(order[len(order) // 2])
    has_grpc = importlib.util.find_spec("grpc") is not None
    reason = ("this machine has no grpcio" if not has_grpc
              else "the smoke imports no grpc")
    print(f"grpc: the transport is not run on the card ({reason}); the "
          f"Lookup handler's body, grpc_server.lookup_bytes, ran without it")
    return {"requests_checked": GRPC_CHECKED, "requests_timed": GRPC_TIMED,
            "ids_per_request": int(reqs[0].shape[0]), "exact": True,
            "bytes_equal_http_answer": True,
            "request_ms_p50": total[p50], "request_ms_max": max(total),
            "codec_ms_p50_request": codec[p50],
            "codec_share_p50": codec[p50] / total[p50],
            "codec_share_max_request": codec[int(np.argmax(total))]
            / max(total),
            "grpcio_on_this_machine": has_grpc, "transport_run": False,
            "launches": launches}


def fused_kernel_phase(torch, cuda_ops, dev, gen, rate, seed):
    """fused_update_scatter against its plain version: every named
    optimizer (f32), Adam and Adagrad (bf16), then the three inputs of
    tools/fused_sweep.py, which are also timed: (a) DLRM's shape, (b) the
    table step's, (c) the operands one full-width DLRM step hands the
    kernel (about two thirds of its rows bound for the trash row)."""
    from recommenders_addons_tpu_torch.ops import optimizer as opt_lib
    from recommenders_addons_tpu_torch.tools import fused_sweep as fs

    def check(inp, what):
        """The kernel on a copy of the table, the plain version on the
        table itself; returns (ulps, max |difference|)."""
        got = inp.table.clone()
        inp.call(got)
        inp.plain(inp.table)
        torch.cuda.synchronize()
        out = fs.compare(got, inp.table, inp, what)
        del got
        return out

    opts = {"sgd": opt_lib.SGD(0.05), "momentum": opt_lib.Momentum(0.05),
            "adagrad": opt_lib.Adagrad(0.05), "adam": opt_lib.Adam(0.05),
            "adamw": opt_lib.AdamW(0.05), "rmsprop": opt_lib.RMSprop(0.05),
            "ftrl": opt_lib.FTRL(0.05, l1_regularization_strength=0.01,
                                 l2_regularization_strength=0.01)}
    checks = {}
    for name, opt in opts.items():
        checks[f"{name}_f32"] = check(fs.fused_inputs(
            dev, gen, opt.fused_rule(), 1, 1 << 20, N_GATHER), name)
    for name in ("adam", "adagrad"):
        checks[f"{name}_bf16"] = check(fs.fused_inputs(
            dev, gen, opts[name].fused_rule(), 2, 1 << 20, N_GATHER),
            f"{name} bf16")
    torch.cuda.empty_cache()

    # (b) the table step's shape: Adam, 2Mi rows, ch = 2, N = 65,536
    inp = fs.fused_inputs(dev, gen, opt_lib.Adam(0.001).fused_rule(), 1,
                          TABLE_CAP, TABLE_N, foreign=False)
    checks["adam_table_step"] = check(inp, "adam table step")
    ts_ms = _time_ms(torch, inp.call, 50)
    ts_bytes, ts_moved = inp.bound_bytes(), inp.moved_bytes()
    del inp
    torch.cuda.empty_cache()

    # (a) DLRM's shape: Adagrad, 4Mi rows, ch = 1, N = 4096 x 26
    n = DLRM_BATCH * FEATURES
    inp = fs.fused_inputs(dev, gen, opt_lib.Adagrad(0.01).fused_rule(), 1,
                          C, n, foreign=False)
    checks["adagrad_dlrm"] = check(inp, "adagrad dlrm")
    ms = _time_ms(torch, inp.call, 50)
    plain_ms = _time_ms(torch, lambda: inp.plain(inp.table), 10)
    w = inp.ch * LANES
    n_bytes, moved = inp.bound_bytes(), inp.moved_bytes()
    n_ops = int(inp.valid().sum()) * DIM * _ADAGRAD_FLOPS
    del inp
    torch.cuda.empty_cache()

    # (c) the main path's own operands: one full-width DLRM step's call
    inp = fs.main_path_inputs(dev, seed)
    checks["adagrad_main_path"] = check(inp, "adagrad main path")
    mp_ms = _time_ms(torch, inp.call, 50)
    mp_bytes, mp_moved = inp.bound_bytes(), inp.moved_bytes()
    mp_trash, mp_n = inp.trash_share(), inp.idx.shape[0]
    del inp
    torch.cuda.empty_cache()
    bound_s = max(n_bytes / rate, n_ops / _F32_FLOPS)
    return {
        "name": "fused_update_scatter", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/"
                  "fused_update_scatter.cu",
        "replaces": "recommenders_addons_tpu/ops/pallas_ops.py:322",
        "replaces_fn": "fused_update_scatter_refs (call :426), tile math "
                       "optimizer._fused_rows_pf1/_pf2",
        "max_abs_err": max(e for _, e in checks.values()),
        "max_ulps": {k: u for k, (u, _) in checks.items()},
        "match": True,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "library_ms": None,
        "library_call": "none (no single PyTorch call fuses a row-wise "
                        "optimizer with an indexed store)",
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / rate >= n_ops / _F32_FLOPS
        else "operations",
        "bytes": n_bytes, "ops": n_ops, "moved_bytes": moved,
        "shape": f"Adagrad C={C} ch=1 W={w} N={n} D={DIM}",
        "table_step_shape": f"Adam C={TABLE_CAP} ch=2 N={TABLE_N} D={DIM}",
        "table_step_ms": ts_ms,
        "table_step_bound_ms": ts_bytes / rate * 1e3,
        "table_step_moved_bytes": ts_moved,
        "main_path_shape": f"one DLRMConfig() step's call: Adagrad C={C} "
                           f"ch=1 N={mp_n} D={DIM}",
        "main_path_ms": mp_ms,
        "main_path_bound_ms": mp_bytes / rate * 1e3,
        "main_path_moved_bytes": mp_moved,
        "main_path_trash_share": mp_trash,
    }


def _count_syncs(torch, fn):
    """``fn()``'s result and how many synchronizing CUDA operations it ran
    (torch.cuda's sync debug mode warns once per such operation)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, n


def _on(torch, batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _narrow_reference(torch, dev, seed, family="dlrm"):
    """A narrow DLRM (or DCN) trains 3 steps on the card and on the CPU
    (the plain versions) from the same weights and batches: key planes,
    scores and sizes bit-exact, losses and rows within NARROW_RTOL /
    NARROW_ATOL (matrix products sum in another order on the card)."""
    from recommenders_addons_tpu_torch import convert
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.models import dcn, dlrm

    if family == "dlrm":
        lib, state_cls = dlrm.DLRM, dlrm.DLRMState
        cfg = dlrm.DLRMConfig(num_sparse=4, dim=8, bottom_sizes=(16, 8),
                              top_sizes=(16, 1), table_capacity=1024)
        to_np, from_np = convert.dlrm_dense_to_numpy, \
            convert.dlrm_dense_from_numpy
    else:
        lib, state_cls = dcn.DCN, dcn.DCNState
        cfg = dcn.DCNConfig(num_sparse=4, dim=8, num_cross=2,
                            deep_sizes=(16, 8), table_capacity=1024)
        to_np, from_np = convert.dcn_dense_to_numpy, \
            convert.dcn_dense_from_numpy
    rng = np.random.default_rng(seed)
    batches = [dlrm.synthetic_criteo_batch(rng, 64, num_sparse=4,
                                           vocab_per_feature=400)
               for _ in range(3)]
    weights = None
    runs = {}
    for where in ("cpu", dev):
        model = lib(cfg, device=where)
        state = model.init(seed)
        if weights is None:
            weights = to_np(state.dense)
        dense = from_np(weights, cfg, device=where)
        state = state_cls(
            table=de.create_slots(model.var, state.table, model.opt),
            dense=dense, step=0)
        step, tx = model.make_train_step()
        opt_state = tx.init(list(dense.parameters()))
        losses = []
        for b in batches:
            state, opt_state, loss = step(state, opt_state, _on(torch, b,
                                                                where))
            losses.append(float(loss))
        runs[str(where)] = (losses, state.table,
                            int(model.var.size(state.table)))
    (cl, ct, cn), (gl, gt, gn) = runs["cpu"], runs[str(dev)]
    if not np.allclose(gl, cl, rtol=NARROW_RTOL, atol=NARROW_ATOL):
        raise AssertionError(f"narrow {family} losses: card {gl}, CPU {cl}")
    for f in ("key_lo", "key_hi", "scores"):
        if not torch.equal(getattr(gt, f).cpu(), getattr(ct, f)):
            raise AssertionError(f"narrow {family} {f}: card and CPU "
                                 f"differ")
    if gn != cn:
        raise AssertionError(f"narrow {family} size: card {gn}, CPU {cn}")
    rows_err = float((gt.rows_logical.cpu() - ct.rows_logical).abs().max())
    if not torch.allclose(gt.rows_logical.cpu(), ct.rows_logical,
                          rtol=NARROW_RTOL, atol=NARROW_ATOL):
        raise AssertionError(f"narrow {family} rows differ by {rows_err}")
    return {"steps": 3, "batch": 64, "losses_card": gl, "losses_cpu": cl,
            "size": gn, "rows_max_abs_err": rows_err,
            "rtol": NARROW_RTOL, "atol": NARROW_ATOL}


def _train_full_width(torch, cuda_ops, dev, model, seed, steps, n_extra,
                      what):
    """The main path of a full-width CTR trainer (DLRM or DCN): its
    Adagrad slots made first, as bench.py's DLRM cell does, then
    ``steps`` steps of DLRM_BATCH through train_loop with the launch
    counts set to 0 just before and read just after (row_gather and
    fused_update_scatter must have launched); then the host syncs of one
    more step and a profiler trace of 3. Returns the numbers, the losses
    by step and a closure that runs one more step (``n_extra`` batches
    are made for the steps after the main path); the closure's ``state()``
    gives the state after the steps run so far."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.models import dlrm
    from recommenders_addons_tpu_torch.train import LoopConfig, train_loop

    state = model.init(seed)
    state = dataclasses.replace(
        state, table=de.create_slots(model.var, state.table, model.opt))
    train_step, tx = model.make_train_step()
    opt_state = [tx.init(list(state.dense.parameters()))]
    rng = np.random.default_rng(seed)
    batches = [dlrm.synthetic_criteo_batch(rng, DLRM_BATCH)
               for _ in range(steps + n_extra)]

    def step_fn(st, batch):
        st, opt_state[0], loss = train_step(st, opt_state[0], batch)
        return st, {"loss": loss}

    losses, stamps = {}, {}

    def on_log(step, metrics):  # reading the loss waits for the step
        losses[step] = metrics["loss"]
        stamps[step] = time.perf_counter()

    # -- the main path: counters from 0, train, read counters ------------
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    state, report = train_loop(step_fn, state, batches[:steps],
                               LoopConfig(steps=steps, log_every=1),
                               on_log=on_log)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_ops.KERNELS}
    for k in ("row_gather", "fused_update_scatter", "init_rows"):
        if not launches[k]:
            raise AssertionError(f"{k} was not launched in {what}: "
                                 f"{launches}")
    size = int(model.params.size(state.table))
    ms_step = (stamps[steps] - stamps[1]) / (steps - 1) * 1e3

    # -- after the checked run: host syncs of one step (its batch already
    # on the card, as train_loop stages it), a trace of 3 ---------------
    extra = iter([_on(torch, b, dev) for b in batches[steps:]])
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], next(extra))

    one_step.state = lambda: holder[0]
    _, syncs = _count_syncs(torch, one_step)
    busy, top = _device_profile(torch, one_step, iters=3, top_n=10)
    out = {
        "batch": DLRM_BATCH, "keys_per_step": DLRM_BATCH * FEATURES,
        "steps": report.steps, "loss_step_1": losses[1],
        f"loss_step_{steps}": losses[steps],
        "losses": [losses[i] for i in sorted(losses)],
        "table_keys_after": size, "train_loop_wall_s": wall_s,
        "ms_per_step": ms_step,
        "examples_per_s": DLRM_BATCH / (ms_step / 1e3),
        "host_syncs_per_step": syncs,
        "device_busy_share": busy, "top_device_ops_ms": top,
        "launches": launches,
    }
    return out, losses, one_step


def training_phase(torch, cuda_ops, dev, seed):
    """Phase 3: the DLRM trainer on the card (narrow reference check, then
    full width through train_loop)."""
    from recommenders_addons_tpu_torch.models import dlrm

    reference = _narrow_reference(torch, dev, seed)
    out, losses, _ = _train_full_width(
        torch, cuda_ops, dev, dlrm.DLRM(dlrm.DLRMConfig()), seed,
        DLRM_STEPS, 5, "training")
    first, last = losses[1], losses[DLRM_STEPS]
    if not (math.isfinite(first) and math.isfinite(last) and last < first):
        raise AssertionError(f"DLRM loss {first} at step 1, {last} at step "
                             f"{DLRM_STEPS}: not finite and falling")
    return {
        "config": "DLRMConfig() (dim 64, 26 features, bottom 13-512-256-64, "
                  "top 415-512-256-1, table 4Mi slots + Adagrad "
                  "accumulator, f32)",
        **out, "narrow_reference": reference,
    }


def table_step_phase(torch, cuda_ops, dev, seed):
    """Phase 4: bench.py's table step (dim 64, 2Mi slots, Adam,
    normal(0.05)) on hit, duplicate, fresh and evicting batches."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    var = de.Variable(name="bench_table", dim=DIM, init_capacity=TABLE_CAP,
                      initializer=de.initializers.normal(0.05))
    opt = de.Adam(0.001)
    state = de.create_slots(var, var.init(), opt)
    rng = np.random.default_rng(seed)
    base_np = np.unique(rng.integers(1, 1 << 62, size=TABLE_N + 4096))
    base_np = rng.permutation(base_np)[:TABLE_N].astype(np.int64)
    base = torch.from_numpy(base_np).to(dev)
    zipf = torch.from_numpy(base_np[(rng.zipf(1.2, size=TABLE_N) - 1)
                                    % TABLE_N]).to(dev)
    holder = {"state": state, "step": 0, "ctx": None}

    def step(keys):
        s = holder["step"]
        emb, ctx = var.embedding_lookup(holder["state"], keys, step=s + 2)
        holder["state"] = var.apply_gradients(holder["state"], ctx,
                                              emb * 0.01, opt, step=s)
        holder["step"], holder["ctx"] = s + 1, ctx
        return ctx

    def timed(make_keys, reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            step(make_keys())
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    def fresh():  # bench.py fresh_keys: ids ^ (step + 1)
        return base ^ (holder["step"] + 1 + (1 << 40))

    # -- the main path: counters from 0 ----------------------------------
    cuda_ops.reset_launches()
    out = {"config": "dim 64, capacity 2Mi, Adam(0.001), normal(0.05), "
                     "LRU stamped at lookup (bench.py)", "batch": TABLE_N}
    ctx = step(base)  # cold: every id inserted
    out["insert_inserted"] = int(ctx.inserted.sum())
    out["hit_ms"] = timed(lambda: base, 10)
    ctx = holder["ctx"]
    if not (bool(ctx.found.all()) and ctx.no_dups):
        raise AssertionError("the hit batch should find every id, once")
    _, out["hit_host_syncs"] = _count_syncs(torch, lambda: step(base))
    out["zipf_dup_ms"] = timed(lambda: zipf, 10)
    ctx = holder["ctx"]
    out["zipf_distinct"] = int(ctx.found.sum())
    if ctx.no_dups or not ctx.rows_aligned:
        raise AssertionError("the zipf batch should hit with duplicates")
    out["fresh_ms"] = timed(fresh, 5)
    if int(holder["ctx"].inserted.sum()) == 0:
        raise AssertionError("fresh ids should be inserted")
    _, out["fresh_host_syncs"] = _count_syncs(torch, lambda: step(fresh()))
    # fill to capacity, then fresh ids must evict (_kth_lowest_slot)
    g = torch.Generator(device=dev).manual_seed(seed)
    for i in range(3):
        keys = torch.randint(1, 1 << 62, (1 << 20,), device=dev,
                             generator=g)
        vals = torch.randn((1 << 20, DIM), device=dev, generator=g) * 0.05
        holder["state"] = var.upsert(holder["state"], keys, vals,
                                     step=holder["step"] + 1)
        holder["step"] += 1
    out["size_before_evict"] = int(var.size(holder["state"]))
    before = holder["state"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ctx = step(fresh())
    torch.cuda.synchronize()
    out["evict_ms"] = (time.perf_counter() - t) * 1e3
    ins = ctx.inserted
    victims = int((before.keys[ctx.slot[ins].long()] != var.empty_key).sum())
    out.update(evict_inserted=int(ins.sum()), evict_victims=victims,
               evict_dropped=int(ctx.dropped.sum()))
    if victims == 0:
        raise AssertionError("the full table's fresh batch evicted no key")
    launches = {k.name: k.launches for k in cuda_ops.KERNELS}
    for k in ("row_gather", "fused_update_scatter", "init_rows"):
        if not launches[k]:
            raise AssertionError(f"{k} was not launched in the table step: "
                                 f"{launches}")
    rows = holder["state"].rows
    if not bool(torch.isfinite(rows).all()):
        raise AssertionError("the table step left non-finite rows")
    out["launches"] = launches
    for k in ("hit", "zipf_dup", "fresh"):
        out[f"{k}_keys_per_s"] = TABLE_N / (out[f"{k}_ms"] / 1e3)
    return out


def _optax_batches(seed, n_steps, n, universe_n, what):
    """``n_steps`` batches of ``n`` zipf(1.2) ids drawn from a seeded
    universe of ``universe_n`` distinct keys (numpy), and the universe."""
    rng = np.random.default_rng([seed, what])
    universe = np.unique(rng.integers(1, 1 << 62, size=universe_n + 4096))
    universe = rng.permutation(universe)[:universe_n].astype(np.int64)
    idx = [(rng.zipf(1.2, size=n) - 1) % universe_n for _ in range(n_steps)]
    return universe, idx


def _optax_table(de, name, dim, cap, device=None):
    return de.Variable(name=name, dim=dim, init_capacity=cap,
                       initializer=de.initializers.normal(0.05),
                       device=device)


def _optax_steps(sv, st, opt, batches, grads=None):
    """Lookup + apply over ``batches`` (device tensors of ids) on a table
    or a sharded table; ``grads[i]`` or ``emb * 0.01``. The lookup stamps
    step i + 1, the apply i (the DLRM trainer's convention)."""
    for i, ids in enumerate(batches):
        emb, ctx = sv.embedding_lookup(st, ids, step=i + 1)
        g = grads[i] if grads is not None else emb * 0.01
        st = sv.apply_gradients(st, ctx, g, opt, step=i)
    return st


def _optax_full_width(torch, cuda_ops, de, transforms, dev, seed):
    """The adapter and the named fused Adam at the table step's width:
    OPTAX_WARM + OPTAX_TIMED steps, then one step under the sync counter
    and 1 + OPTAX_PROFILED under torch.profiler, each table on the same
    batches; then check (a): every key's count column is the number of
    steps whose batch held the key."""
    n_steps = OPTAX_WARM + OPTAX_TIMED + 1 + 1 + OPTAX_PROFILED
    universe, idx = _optax_batches(seed, n_steps, TABLE_N, OPTAX_UNIVERSE,
                                   1)
    batches = [torch.from_numpy(universe[i]).to(dev) for i in idx]
    out = {"config": "dim 64, capacity 2Mi, f32, normal(0.05), LRU; "
                     "DynamicEmbeddingOptimizer(transforms.adam(1e-3)) "
                     "beside the named Adam(1e-3)",
           "batch": TABLE_N, "universe_keys": OPTAX_UNIVERSE,
           "warm_steps": OPTAX_WARM, "timed_steps": OPTAX_TIMED}
    runs = {"adapter": de.DynamicEmbeddingOptimizer(transforms.adam(1e-3)),
            "named_adam": de.Adam(1e-3)}
    for run, opt in runs.items():
        var = _optax_table(de, f"optax_{run}", DIM, TABLE_CAP)
        holder = {"st": de.create_slots(var, var.init(), opt), "i": 0}

        def step():
            i = holder["i"]
            emb, ctx = var.embedding_lookup(holder["st"], batches[i],
                                            step=i + 1)
            holder["st"] = var.apply_gradients(holder["st"], ctx, emb * 0.01,
                                               opt, step=i)
            holder["i"] = i + 1
            return ctx

        cuda_ops.reset_launches()
        for _ in range(OPTAX_WARM):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(OPTAX_TIMED):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / OPTAX_TIMED * 1e3
        ctx, syncs = _count_syncs(torch, step)
        busy, top = _device_profile(torch, step, iters=OPTAX_PROFILED)
        launches = _launched(
            cuda_ops, run, ("row_gather", "row_scatter") if run == "adapter"
            else ("row_gather", "fused_update_scatter"), phase="optax")
        if run == "adapter" and launches["fused_update_scatter"]:
            raise AssertionError("the optax adapter took the fused path")
        if holder["i"] != n_steps:
            raise AssertionError(f"{holder['i']} steps run, {n_steps} drawn")
        st = holder["st"]
        size = int(var.size(st))
        if not bool(torch.isfinite(st.rows_logical[:TABLE_CAP]).all()):
            raise AssertionError(f"{run}: non-finite rows")
        out[run] = {"ms_per_step": ms, "host_syncs_per_step": syncs,
                    "device_busy_share": busy, "top_kernels_ms": top,
                    "slots": list(st.slot_names), "live_keys": size,
                    "launches": launches}
        if run == "adapter":
            # (a) the per-row step counts against numpy's
            seen = np.zeros(OPTAX_UNIVERSE, np.int64)
            for i in idx:
                seen[np.unique(i)] += 1
            want_keys = np.sort(universe[seen > 0])
            want_counts = seen[seen > 0][np.argsort(universe[seen > 0])]
            got = _per_key(torch, var, st)
            if not np.array_equal(got["keys"].cpu().numpy(), want_keys):
                raise AssertionError(
                    f"adapter: {got['keys'].numel()} live keys, "
                    f"{want_keys.size} drawn (an id was evicted or dropped)")
            off = st.slot_offset("optax_0")
            counts = got["rows"][:, off:off + DIM].view(torch.float32)
            want = torch.from_numpy(want_counts.astype(np.float32)).to(dev)
            if not torch.equal(counts, want[:, None].expand_as(counts)):
                bad = int((counts != want[:, None]).any(1).sum())
                raise AssertionError(f"adapter: {bad} keys' count columns "
                                     f"differ from numpy's")
            out["check_a"] = {"keys": int(want_keys.size),
                              "count_max": int(want_counts.max()),
                              "count_mean": float(want_counts.mean()),
                              "counts_exact": True}
        del var, holder, st, ctx
        torch.cuda.empty_cache()
    out["adapter_over_named_adam"] = (out["adapter"]["ms_per_step"]
                                      / out["named_adam"]["ms_per_step"])
    return out


def _optax_narrow(torch, de, transforms, dev, seed):
    """(b) dim OPTAX_NARROW[0], OPTAX_NARROW[1] slots, OPTAX_NARROW[2]
    steps of zipf ids, on the card and on the CPU from the same grads:
    key planes, scores and count columns bit-exact, rows and moments
    within SURFACE_RTOL / SURFACE_ATOL."""
    dim, cap, steps, n, universe_n = OPTAX_NARROW
    universe, idx = _optax_batches(seed, steps, n, universe_n, 2)
    rng = np.random.default_rng([seed, 3])
    grads = [rng.normal(size=(n, dim)).astype(np.float32)
             for _ in range(steps)]
    states = {}
    for where in (dev, torch.device("cpu")):
        var = _optax_table(de, "optax_narrow", dim, cap, device=where)
        opt = de.DynamicEmbeddingOptimizer(transforms.adam(1e-3))
        states[where.type] = (var, _optax_steps(
            var, var.init(), opt,
            [torch.from_numpy(universe[i]).to(where) for i in idx],
            [torch.from_numpy(g).to(where) for g in grads]))
    (var, card), (_, cpu) = states["cuda"], states["cpu"]
    for f in ("key_lo", "key_hi", "scores"):
        if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"optax narrow: {f} differ card vs CPU")
    off = card.slot_offset("optax_0")
    a = card.rows_logical[:cap].cpu()
    b = cpu.rows_logical[:cap]
    if not torch.equal(a[:, off:off + dim], b[:, off:off + dim]):
        raise AssertionError("optax narrow: count columns differ")
    err = _rows_close(torch, a, b, "optax narrow")
    return {"dim": dim, "capacity": cap, "steps": steps, "batch": n,
            "universe_keys": universe_n, "live_keys": int(var.size(card)),
            "planes_and_counts_bit_exact": True, "rows_max_abs_err": err,
            "rows_bit_equal": bool(torch.equal(a, b)),
            "rtol": SURFACE_RTOL, "atol": SURFACE_ATOL}


def _optax_sharded(torch, cuda_ops, de, transforms, dev, seed):
    """(c) SHARDS logical shards of the card with the adapter, at the
    table step's width, OPTAX_SHARD_STEPS steps, per key against one
    table (the same keys, scores and count columns; rows and moments
    within SHARD_RTOL / SHARD_ATOL). The sharded run is a main path:
    row_gather and row_scatter must launch."""
    from recommenders_addons_tpu_torch import parallel

    universe, idx = _optax_batches(seed, OPTAX_SHARD_STEPS, TABLE_N,
                                   OPTAX_UNIVERSE, 4)
    batches = [torch.from_numpy(universe[i]).to(dev) for i in idx]
    opt = de.DynamicEmbeddingOptimizer(transforms.adam(1e-3))
    single = _optax_table(de, "optax_shard", DIM, TABLE_CAP)
    st1 = _optax_steps(single, de.create_slots(single, single.init(), opt),
                       opt, batches)
    want = _per_key(torch, single, st1)
    del st1
    torch.cuda.empty_cache()
    sv = parallel.ShardedVariable(
        _optax_table(de, "optax_shard", DIM, TABLE_CAP),
        parallel.create_mesh(devices=[dev] * SHARDS))
    cuda_ops.reset_launches()
    t = time.perf_counter()
    st4 = _optax_steps(sv, sv.create_slots(sv.init(), opt), opt, batches)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / OPTAX_SHARD_STEPS * 1e3
    launches = _launched(cuda_ops, "sharded", ("row_gather", "row_scatter"),
                         phase="optax")
    got = _per_key(torch, sv.var, st4)
    off = st4.shards[0].slot_offset("optax_0")
    if not torch.equal(got["rows"][:, off:off + DIM],
                       want["rows"][:, off:off + DIM]):
        raise AssertionError("optax sharded: count columns differ")
    err, same = _rows_agree(torch, got, want, "optax sharded vs unsharded")
    del st4
    torch.cuda.empty_cache()
    return {"shards": SHARDS, "steps": OPTAX_SHARD_STEPS, "batch": TABLE_N,
            "ms_per_step": ms, "live_keys": int(want["keys"].numel()),
            "counts_bit_exact": True, "rows_max_abs_err": err,
            "rows_bit_equal": same, "rtol": SHARD_RTOL, "atol": SHARD_ATOL,
            "launches": launches}


def optax_phase(torch, cuda_ops, dev, seed):
    """The optax-style adapter (OptaxSparseOptimizer over
    transforms.adam) at the table step's full width beside the named
    fused Adam, then checks (b) and (c)."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch import transforms

    t0 = time.perf_counter()
    out = _optax_full_width(torch, cuda_ops, de, transforms, dev, seed)
    out["check_b_narrow"] = _optax_narrow(torch, de, transforms, dev, seed)
    out["check_c_sharded"] = _optax_sharded(torch, cuda_ops, de, transforms,
                                            dev, seed)
    out["launches"] = {
        "optax": out["adapter"]["launches"],
        "optax_named_adam": out["named_adam"]["launches"],
        "optax_sharded": out["check_c_sharded"]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    return out


def _clone_state(st):
    """A copy of a table state (the row kernels write ``rows`` in place)."""
    return st.replace(key_lo=st.key_lo.clone(), key_hi=st.key_hi.clone(),
                      rows=st.rows.clone(), scores=st.scores.clone())


def _launched(cuda_ops, part, names, phase="training_surface"):
    """This part's launch counts; fails if a kernel of ``names`` was not
    launched."""
    launches = {k.name: k.launches for k in cuda_ops.KERNELS}
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"{missing} not launched in {phase} {part}: "
                             f"{launches}")
    return launches


def _rows_close(torch, got, want, what):
    """Rows [0, C) within the training tests' f32 tolerance (rtol 1e-5,
    atol 1e-6); returns the max |difference|."""
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=SURFACE_RTOL, atol=SURFACE_ATOL):
        raise AssertionError(f"{what}: rows differ by up to {err}")
    return err


def training_surface_phase(torch, cuda_ops, dev, seed):
    """Phase 5: the rest of the training surface at the table step's full
    width (Variable(dim=64, init_capacity=2Mi, Adam(0.001), LRU,
    normal(0.05)), batches of 65,536 ids made as table_step_phase makes
    them): (a) deferred dedup, (b) bp_v2, (c) return_evicted on the fused
    and the unfused path, (d) import_batch / accum / remove / clear, (e)
    plan_lookup_fast. The launch counts are reset before each part."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.ops import hashing
    from recommenders_addons_tpu_torch.ops import hashtable as ht
    from recommenders_addons_tpu_torch.tools.fused_sweep import max_ulps

    opt = de.Adam(0.001)

    def variable(**kw):
        return de.Variable(name="surface", dim=DIM, init_capacity=TABLE_CAP,
                           initializer=de.initializers.normal(0.05), **kw)

    var = variable()
    spec = var.spec
    rng = np.random.default_rng(seed)
    base_np = np.unique(rng.integers(1, 1 << 62, size=TABLE_N + 4096))
    base_np = rng.permutation(base_np)[:TABLE_N].astype(np.int64)
    base = torch.from_numpy(base_np).to(dev)
    zipfs = [torch.from_numpy(base_np[(rng.zipf(1.2, size=TABLE_N) - 1)
                                      % TABLE_N]).to(dev)
             for _ in range(SURFACE_STEPS)]
    start = de.create_slots(var, var.init(), opt)
    _, ctx = var.embedding_lookup(start, base, step=1)
    start = var.apply_gradients(start, ctx, torch.zeros_like(ctx.rows), opt,
                                step=1)
    out = {"config": "Variable(dim=64, init_capacity=2Mi, Adam(0.001), LRU, "
                     "normal(0.05)); batches of 65,536 ids",
           "launches": {}}

    # each occurrence's gradient: its row x 0.01 plus noise of its own,
    # the same in every run (duplicates of a key get different grads, so
    # the order of their sum shows in the rows)
    gn = torch.Generator(device=dev).manual_seed(seed + 1)
    noise = [torch.randn((TABLE_N, DIM), device=dev, generator=gn) * 1e-3
             for _ in range(max(SURFACE_STEPS, SURFACE_BP_STEPS))]

    def run(v, st, batches, lookup_ahead, t0=2):
        """Lookup + apply over ``batches``; returns (state, ms/step, ctxs).
        Host clock around the steps with one sync, as table_step_phase."""
        ctxs = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i, keys in enumerate(batches):
            s = t0 + i
            emb, ctx = v.embedding_lookup(st, keys, step=s + lookup_ahead)
            st = v.apply_gradients(st, ctx, emb * 0.01 + noise[i], opt,
                                   step=s)
            ctxs.append(ctx)
        torch.cuda.synchronize()
        return st, (time.perf_counter() - t) / len(batches) * 1e3, ctxs

    # -- (a) deferred dedup: zipf duplicates, step given at lookup --------
    cuda_ops.reset_launches()
    deferred = variable(defer_dedup=True)
    d1, d_ms, ctxs = run(deferred, _clone_state(start), zipfs, 2)
    out["launches"]["deferred"] = _launched(cuda_ops, "(a)",
                                            ["row_gather",
                                             "fused_update_scatter"])
    if cuda_ops.FUSED_UPDATE_SCATTER.launches != SURFACE_STEPS:
        raise AssertionError("the deferred steps did not each launch "
                             "fused_update_scatter")
    if not all(c.deferred and c.rows_aligned and not c.no_dups
               and bool(c.found.all()) for c in ctxs):
        raise AssertionError("the zipf steps should hit with duplicates "
                             "under the occurrence contract")
    eager, e_ms, _ = run(var, _clone_state(start), zipfs, 2)
    d2, _, _ = run(deferred, _clone_state(start), zipfs, 2)
    for f in ("key_lo", "key_hi", "scores"):
        if not torch.equal(getattr(d1, f), getattr(eager, f)):
            raise AssertionError(f"deferred and eager {f} differ")
    cap = spec.capacity
    a_err = _rows_close(torch, d1.rows_logical, eager.rows_logical,
                        "deferred vs eager")
    out["deferred"] = {
        "steps": SURFACE_STEPS, "deferred_ms_per_step": d_ms,
        "eager_ms_per_step": e_ms, "rows_max_abs_err_vs_eager": a_err,
        "ulps_between_two_deferred_runs": max_ulps(
            d1.rows_logical, d2.rows_logical, 32)}
    del d1, d2, eager, ctxs

    # -- (b) bp_v2: the unfused path, against the plain (assigning) apply
    bp_batches = [zipfs[0], base ^ (1 << 41), zipfs[1], base ^ (1 << 42),
                  base][:SURFACE_BP_STEPS]
    cuda_ops.reset_launches()
    bp, bp_ms, _ = run(variable(bp_v2=True), _clone_state(start),
                       bp_batches, 0)
    out["launches"]["bp_v2"] = _launched(cuda_ops, "(b)",
                                         ["row_gather", "row_scatter"])
    if cuda_ops.FUSED_UPDATE_SCATTER.launches:
        raise AssertionError("bp_v2 must take the unfused path")
    plain, plain_ms, _ = run(var, _clone_state(start), bp_batches, 0)
    for f in ("key_lo", "key_hi", "scores"):
        if not torch.equal(getattr(bp, f), getattr(plain, f)):
            raise AssertionError(f"bp_v2 and the plain apply: {f} differ")
    # each write is old + (new - old), within an ulp of new; five Adam
    # steps keep that far inside rtol 1e-5 / atol 1e-6
    out["bp_v2"] = {"steps": len(bp_batches), "ms_per_step": bp_ms,
                    "plain_ms_per_step": plain_ms,
                    "rows_max_abs_err_vs_plain": _rows_close(
                        torch, bp.rows_logical, plain.rows_logical,
                        "bp_v2 vs the plain apply")}
    del bp, plain

    # -- (c) return_evicted: a full table takes one fresh batch ----------
    g = torch.Generator(device=dev).manual_seed(seed)
    full = _clone_state(start)
    step = 3
    while int(var.size(full)) < cap:
        keys = torch.randint(1, 1 << 62, (1 << 20,), device=dev, generator=g)
        vals = torch.randn((1 << 20, DIM), device=dev, generator=g) * 0.05
        full = var.upsert(full, keys, vals, step=step)
        step += 1
    # fresh ids, SURFACE_CROWD of them in one bucket: more than it holds
    cand = torch.randint(1 << 61, 1 << 62, (SURFACE_CROWD * spec.num_buckets
                                           * 4,), device=dev, generator=g)
    crowd = cand[hashing.bucket_of(cand, spec.num_buckets) == 0]
    crowd = crowd.unique()[:SURFACE_CROWD]
    fresh = torch.cat([base[: TABLE_N - crowd.numel()] ^ (1 << 43), crowd])
    out["evicted"] = {}
    for path, v, kernels in (
            ("fused", var, ["row_gather", "fused_update_scatter"]),
            ("unfused_bp_v2", variable(bp_v2=True),
             ["row_gather", "row_scatter"])):
        before = _clone_state(full)
        st = _clone_state(full)
        cuda_ops.reset_launches()
        emb, ctx = v.embedding_lookup(st, fresh, step=step)
        st, ev = v.apply_gradients(st, ctx, emb * 0.01, opt, step=step,
                                   return_evicted=True)
        torch.cuda.synchronize()
        out["launches"][f"evicted_{path}"] = _launched(cuda_ops, "(c)",
                                                       kernels)
        live_b = before.keys[ht.occupancy_mask(spec, before)]
        live_a = st.keys[ht.occupancy_mask(spec, st)]
        gone = live_b[~torch.isin(live_b, live_a)]
        hit = ev["keys"] != var.empty_key
        ev_keys = ev["keys"][hit]
        if not (gone.numel() and torch.equal(gone.sort().values,
                                             ev_keys.sort().values)):
            raise AssertionError(f"{path}: the evicted keys are not the "
                                 f"keys that left the table")
        slot, found = ht.find(spec, before, ev_keys)
        if not bool(found.all()):
            raise AssertionError(f"{path}: an evicted key was not stored")
        rows_b = before.rows_logical[slot.long()]
        checks = [(ev["values"][hit], rows_b[:, :DIM]),
                  (ev["scores"][hit], before.scores[slot.long()])]
        for nm in before.slot_names:
            off = before.slot_offset(nm)
            checks.append((ev["slots"][nm][hit], rows_b[:, off:off + DIM]))
        if any(_same_bits(torch, a, b) for a, b in checks):
            raise AssertionError(f"{path}: evicted rows, slots or scores "
                                 f"differ from the table's before the step")
        dk = ev["dropped_keys"]
        dropped = dk[dk != var.empty_key]
        unplaced = fresh[~torch.isin(fresh, live_a)]
        if not (dropped.numel() and torch.equal(dropped.sort().values,
                                                unplaced.sort().values)):
            raise AssertionError(f"{path}: dropped keys are not the fresh "
                                 f"keys left out")
        out["evicted"][path] = {"evicted": int(hit.sum()),
                                "dropped": int(dropped.numel())}
        del before, st, ev, ctx, emb
    del full
    torch.cuda.empty_cache()

    # -- (d) the KV API: import_batch, accum, remove, clear --------------
    n = SURFACE_IMPORT_N
    keys_np = rng.permutation(np.unique(rng.integers(1, 1 << 62,
                                                     size=n + n // 8)))[:n]
    dup = rng.permutation(n)[: n // 20]  # 5% of the keys repeat another
    keys_np[dup] = keys_np[rng.integers(0, n, size=dup.size)]
    keys_np = keys_np.astype(np.int64)
    cols = {c: rng.normal(size=(n, DIM)).astype(np.float32)
            for c in ("value", "m", "v")}
    sc_np = rng.integers(1, 1 << 20, size=n).astype(np.int32)
    kv = de.create_slots(var, var.init(), opt)
    cuda_ops.reset_launches()
    on = {c: torch.from_numpy(a).to(dev) for c, a in cols.items()}
    kv = var.import_batch(kv, torch.from_numpy(keys_np).to(dev),
                          on["value"], torch.from_numpy(sc_np).to(dev),
                          {"m": on["m"], "v": on["v"]})
    uk, ridx = np.unique(keys_np[::-1], return_index=True)
    last = n - 1 - ridx  # numpy reference: the last occurrence wins
    if int(var.size(kv)) != uk.size:
        raise AssertionError(f"import_batch placed {int(var.size(kv))} of "
                             f"{uk.size} keys")
    slot, _ = ht.find(spec, kv, torch.from_numpy(uk).to(dev))
    rows = kv.rows_logical[slot.long()]
    last_t = torch.from_numpy(last).to(dev)
    for c, off in (("value", 0), ("m", kv.slot_offset("m")),
                   ("v", kv.slot_offset("v"))):
        if _same_bits(torch, rows[:, off:off + DIM], on[c][last_t]):
            raise AssertionError(f"import_batch: {c} is not the last "
                                 f"occurrence's")
    if not np.array_equal(kv.scores[slot.long()].cpu().numpy(), sc_np[last]):
        raise AssertionError("import_batch: scores are not the last "
                             "occurrence's")
    del rows
    # accum: 65,536 ids, stored ones with duplicates and new ones; the
    # exists guard marks 1% of the stored ones absent (stale): skipped
    na = TABLE_N
    stored_ids = uk[rng.integers(0, uk.size, size=na - na // 8)]
    new_ids = np.arange(1, na // 8 + 1, dtype=np.int64) + (1 << 61)
    ak = np.concatenate([stored_ids, new_ids])
    old = rng.normal(size=(na, DIM)).astype(np.float32)
    new = rng.normal(size=(na, DIM)).astype(np.float32)
    exists = np.concatenate([np.ones(stored_ids.size, bool),
                             np.zeros(new_ids.size, bool)])
    stale_keys = np.unique(stored_ids)[::100]
    exists[np.isin(ak, stale_keys)] = False
    kv = var.accum(kv, torch.from_numpy(ak).to(dev),
                   torch.from_numpy(old).to(dev),
                   torch.from_numpy(new).to(dev),
                   exists=torch.from_numpy(exists).to(dev), step=9)
    out["launches"]["kv"] = _launched(cuda_ops, "(d)",
                                      ["row_gather", "row_scatter"])
    # numpy reference in f64: each stored key's imported value plus the
    # sum of its deltas (stale keys unchanged); new keys their new value
    su, inv = np.unique(stored_ids, return_inverse=True)
    sums = np.zeros((su.size, DIM))
    np.add.at(sums, inv, (new - old)[:stored_ids.size].astype(np.float64))
    want_v = cols["value"][last[np.searchsorted(uk, su)]].astype(np.float64)
    fresh_sum = ~np.isin(su, stale_keys)
    want_v[fresh_sum] += sums[fresh_sum]
    wk = np.concatenate([su, new_ids])
    want_v = np.concatenate([want_v, new[stored_ids.size:]])
    got, found = var.lookup(kv, torch.from_numpy(wk).to(dev),
                            return_exists=True)
    if not bool(found.all()):
        raise AssertionError("accum lost a key")
    got = got.cpu().numpy()
    acc_err = float(np.abs(got - want_v).max())
    if not np.allclose(got, want_v, rtol=SURFACE_RTOL, atol=1e-5):
        raise AssertionError(f"accum: per-key sums off by {acc_err}")
    stale_at = np.isin(wk, stale_keys)
    if not np.array_equal(got[stale_at].view(np.int32),
                          want_v[stale_at].astype(np.float32).view(np.int32)):
        raise AssertionError("accum wrote a key its exists guard skips")
    size_accum = int(var.size(kv))
    rm = uk[::2]
    kv = var.remove(kv, torch.from_numpy(rm).to(dev))
    size_remove = int(var.size(kv))
    if size_remove != size_accum - rm.size:
        raise AssertionError(f"remove: {size_accum} -> {size_remove} keys, "
                             f"{rm.size} removed")
    kv = var.clear(kv)
    if int(var.size(kv)) or bool(kv.rows.view(torch.int32).any()):
        raise AssertionError("clear left keys or rows")
    out["kv"] = {"imported": n, "distinct": int(uk.size),
                 "accum_ids": na, "stale": int(stale_keys.size),
                 "accum_max_abs_err": acc_err, "size_after_accum": size_accum,
                 "size_after_remove": size_remove, "size_after_clear": 0}
    del kv, on
    torch.cuda.empty_cache()

    # -- (e) plan_lookup_fast against plan_lookup's contract -------------
    st = start
    fast = {}
    for name, keys in (("hit_unique", base), ("hit_dups", zipfs[0]),
                       ("miss", base ^ (1 << 44))):
        uniq, inv, (slot, found, ins, drop) = ht.plan_lookup_fast(spec, st,
                                                                  keys)
        u2, inv2, (s2, f2, i2, d2), _ = ht.plan_lookup(spec, st, keys)
        inv, inv2 = inv.long(), inv2.long()
        reps = uniq[found | ins | drop]
        if not (torch.equal(uniq[inv], keys)
                and reps.numel() == keys.unique().numel()
                and torch.equal(slot[inv], s2[inv2])
                and torch.equal(found[inv], f2[inv2])
                and torch.equal(ins[inv], i2[inv2])):
            raise AssertionError(f"plan_lookup_fast breaks plan_lookup's "
                                 f"contract on the {name} batch")
        fast[name] = {"distinct": int(reps.numel()),
                      "inserted": int(ins.sum())}
    if fast["miss"]["inserted"] == 0 or fast["hit_dups"]["inserted"]:
        raise AssertionError(f"plan_lookup_fast batches: {fast}")
    out["plan_lookup_fast"] = fast
    return out


def _sparse_batch(seed):
    """SPARSE_ROWS rows of up to SPARSE_LEN zipf(1.2) ids: EMPTY padding,
    every 97th row empty, 1% negative ids, weights uniform in
    [0.1, 2)."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.2, size=(SPARSE_ROWS, SPARSE_LEN)) % (1 << 22)
           + 1).astype(np.int64)
    lens = rng.integers(0, SPARSE_LEN + 1, size=SPARSE_ROWS)
    lens[::97] = 0
    ids[np.arange(SPARSE_LEN)[None, :] >= lens[:, None]] = de.EMPTY_KEY
    neg = (rng.random(ids.shape) < 0.01) & (ids > 0)
    ids[neg] *= -1
    w = rng.uniform(0.1, 2.0, size=ids.shape).astype(np.float32)
    return ids, w


def _sparse_inputs(torch, de, kind, ids, w, where):
    """The batch as padded-dense ids, SparseIds or RaggedIds on ``where``
    (with its [nnz] weights)."""
    if kind == "dense":
        return (torch.from_numpy(ids).to(where),
                torch.from_numpy(w).to(where))
    if kind == "sparse":
        sp = de.dense_to_sparse(torch.from_numpy(ids).to(where))
        return sp, torch.from_numpy(w.reshape(-1)).to(where)
    keep = ids != de.EMPTY_KEY
    splits = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int32)
    pad = ids.size - int(keep.sum())  # tail padding, masked by the splits
    vals = np.concatenate([ids[keep], np.full(pad, 5, np.int64)])
    wv = np.concatenate([w[keep], np.ones(pad, np.float32)])
    return (de.RaggedIds(torch.from_numpy(vals).to(where),
                         torch.from_numpy(splits).to(where)),
            torch.from_numpy(wv).to(where))


def _sparse_api_part(torch, cuda_ops, dev, seed):
    """Models phase (c): the sparse API at DCN's table width (dim 32,
    Adagrad(0.01), uniform(0.05), LRU; SPARSE_CAP slots) on the card and
    on a CPU copy, step by step: each input type, each lookup and
    combiner, then apply_sparse_gradients with the same gradient."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    ids, w = _sparse_batch(seed)
    opt = de.Adagrad(0.01)
    vars_, states = {}, {}
    for where in ("cpu", dev):
        var = de.Variable(name="sparse_api", dim=32,
                          init_capacity=SPARSE_CAP,
                          initializer=de.initializers.uniform(0.05),
                          device=where)
        vars_[str(where)] = var
        states[str(where)] = de.create_slots(var, var.init(), opt)
    cpu, card = "cpu", str(dev)
    rng = np.random.default_rng(seed + 1)
    out = {"rows": SPARSE_ROWS, "max_len": SPARSE_LEN,
           "ids": int(ids.size), "empty_rows": int(
               (ids == de.EMPTY_KEY).all(1).sum()),
           "negative_ids": int(((ids < 0) & (ids != de.EMPTY_KEY)).sum()),
           "steps": 0, "combined_max_abs_err": 0.0,
           "row_grad_max_abs_err": 0.0}
    card_s = 0.0
    cuda_ops.reset_launches()
    for kind in ("dense", "sparse", "ragged"):
        ins = {str(w_): _sparse_inputs(torch, de, kind, ids, w, w_)
               for w_ in ("cpu", dev)}
        for combiner in ("sum", "mean", "sqrtn"):
            for fn, kw in ((de.embedding_lookup_sparse, {}),
                           (de.safe_embedding_lookup_sparse, {}),
                           (de.safe_embedding_lookup_sparse,
                            {"default_id": 7})):
                what = f"{kind} {fn.__name__} {combiner} {kw}"
                step = out["steps"]
                g = rng.normal(size=(SPARSE_ROWS, 32)).astype(np.float32)
                res = {}
                for where in (cpu, card):
                    ids_in, w_in = ins[where]
                    var, st = vars_[where], states[where]
                    t = time.perf_counter()
                    c, ctx = fn(var, st, ids_in, w_in, combiner=combiner,
                                **kw)
                    gt = torch.from_numpy(g).to(where)
                    rg = ctx.row_gradient(gt)
                    states[where] = de.apply_sparse_gradients(
                        var, st, ctx, gt, opt, step=step)
                    if where == card:
                        torch.cuda.synchronize()
                        card_s += time.perf_counter() - t
                    res[where] = (c.cpu(), rg.cpu())
                (cc, cg), (gc, gg) = res[cpu], res[card]
                if not (torch.allclose(gc, cc, rtol=SURFACE_RTOL,
                                       atol=SURFACE_ATOL)
                        and torch.allclose(gg, cg, rtol=SURFACE_RTOL,
                                           atol=SURFACE_ATOL)):
                    raise AssertionError(f"sparse API {what}: the card's "
                                         f"combine or row gradient differs")
                out["combined_max_abs_err"] = max(
                    out["combined_max_abs_err"],
                    float((gc - cc).abs().max()))
                out["row_grad_max_abs_err"] = max(
                    out["row_grad_max_abs_err"], float((gg - cg).abs().max()))
                for f in ("key_lo", "key_hi", "scores"):
                    if not torch.equal(getattr(states[card], f).cpu(),
                                       getattr(states[cpu], f)):
                        raise AssertionError(f"sparse API {what}: {f} "
                                             f"differ, card against CPU")
                out["steps"] += 1
        n_card = int(vars_[card].size(states[card]))
        if n_card != int(vars_[cpu].size(states[cpu])):
            raise AssertionError(f"sparse API {kind}: sizes differ")
        out[f"size_after_{kind}"] = n_card
        out[f"rows_max_abs_err_{kind}"] = _rows_close(
            torch, states[card].rows_logical.cpu(),
            states[cpu].rows_logical, f"sparse API {kind}")
    launches = _launched(cuda_ops, "(c) sparse API",
                         ("row_gather", "fused_update_scatter"), "models")
    out.update(card_ms_per_step=card_s / out["steps"] * 1e3,
               launches=launches, rtol=SURFACE_RTOL, atol=SURFACE_ATOL)
    return out


def _learning_bars(torch, cuda_ops):
    """Models phase (d): each family's run_demo on the card with the JAX
    package's test seeds and sizes, held to the JAX tests' bars."""
    from recommenders_addons_tpu_torch.models import (dcn, movielens,
                                                      retrieval,
                                                      seq_and_dense)

    runs = (
        ("movielens", lambda: movielens.run_demo(150, 256, log_every=0),
         lambda tr, ev: ev < 1.0, "eval MSE < 1.0"),
        ("movielens_multi_hot",
         lambda: movielens.run_demo(60, 128, multi_hot=True, log_every=0),
         lambda tr, ev: math.isfinite(tr) and ev < 2.0,
         "train MSE finite, eval MSE < 2.0"),
        ("retrieval", lambda: retrieval.run_demo(250, 256),
         lambda tr, ev: ev > 0.8, "recall > 0.8"),
        ("dcn", lambda: dcn.run_demo(60, 256, dim=8, log_every=0),
         lambda tr, ev: math.isfinite(tr) and ev > 0.6,
         "loss finite, AUC > 0.6"),
        ("seq_and_dense", lambda: seq_and_dense.run_demo(150, 256),
         lambda tr, ev: ev < 0.5, "eval MSE < 0.5"),
    )
    out = {}
    cuda_ops.reset_launches()
    for name, run, bar, says in runs:
        t = time.perf_counter()
        train, metric = run()
        out[name] = {"train": train, "metric": metric, "bar": says,
                     "s": time.perf_counter() - t}
        if not bar(train, metric):
            raise AssertionError(f"{name}: {train}, {metric} misses the JAX "
                                 f"test's bar ({says})")
    out["launches"] = _launched(cuda_ops, "(d) learning bars",
                                ("row_gather", "fused_update_scatter"),
                                "models")
    return out


def _own_call_check(torch, cuda_ops, one_step, n_fused, n_gathers, what):
    """Kernels 1 and 3 on one more step's own operands against their plain
    versions: the step's first ``n_gathers`` row gathers bit-exact, and
    each of its fused applies (it must make ``n_fused``) within
    ``fused_sweep.compare``'s ulps. Raises on a mismatch."""
    from recommenders_addons_tpu_torch.tools import fused_sweep as fs

    calls = []
    gathers = fs.record_calls(
        lambda: calls.extend(fs.record_calls(one_step)),
        "gather_rows_2d", limit=n_gathers)
    gather_err, n_rec = 0, len(gathers)
    while gathers:
        a = gathers.pop(0)
        gather_err = max(gather_err, _same_bits(
            torch, cuda_ops.gather_rows_2d(**a),
            cuda_ops.gather_rows_2d_plain(**a)))
    if not n_rec or gather_err:
        raise AssertionError(f"row_gather on a {what}'s operands: "
                             f"{n_rec} calls, {gather_err} apart")
    if len(calls) != n_fused:
        raise AssertionError(f"one {what} called the fused apply "
                             f"{len(calls)} times, not {n_fused}")
    ulps, err, trash = 0, 0.0, []
    while calls:
        inp = fs.Inputs.of_call(calls.pop(0))
        got = inp.table.clone()
        inp.call(got)
        inp.plain(inp.table)
        torch.cuda.synchronize()
        u, e = fs.compare(got, inp.table, inp, f"adagrad {what}")
        ulps, err = max(ulps, u), max(err, e)
        trash.append(inp.trash_share())
        del inp, got
    torch.cuda.empty_cache()
    return {"row_gather_own_calls": n_rec,
            "row_gather_own_calls_max_abs_err": gather_err,
            "fused_own_calls": n_fused,
            "fused_own_call_ulps_max_abs_err": [ulps, err],
            "fused_own_call_trash_share": trash}


def _dcnv2_batch(rng, sizes):
    """DCNV2_BATCH examples of MLPerf's bags (see DCNV2_ZIPF): ``sparse``
    [B, sum(sizes)] raw ids, columns grouped by feature."""
    b, vocab = DCNV2_BATCH, np.uint64(DCNV2_VOCAB)
    cols = []
    for f, s in enumerate(sizes):
        first = rng.zipf(DCNV2_ZIPF, size=b).astype(np.uint64) % vocab
        cols.append(first)
        for j in range(1, s):
            h = first * np.uint64(0x9E3779B97F4A7C15) + np.uint64(j * 7919 + f)
            cols.append((h ^ (h >> np.uint64(31))) % vocab)
    return {"dense": rng.normal(size=(b, 13)).astype(np.float32),
            "sparse": np.stack(cols, 1).astype(np.int64),
            "label": (rng.random(b) < 0.5).astype(np.float32)}


def _own_init_rows_check(torch, cuda_ops, calls, what):
    """Kernel 10 on a step's recorded calls against its plain version,
    bit-exact on int32 views. Returns the number of calls checked."""
    for a in calls:
        got, want = a["rows"].clone(), a["rows"]
        rest = {k: v for k, v in a.items() if k != "rows"}
        cuda_ops.init_rows(got, **rest)
        cuda_ops.init_rows_plain(want, **rest)
        err = _same_bits(torch, got, want)
        if err:
            raise AssertionError(f"init_rows on a {what}'s operands: "
                                 f"{err} apart")
    return len(calls)


def _dcnv2_part(torch, cuda_ops, dev, seed):
    """Models phase (e): DLRMDCNv2() at MLPerf's published widths (dim 128,
    bottom 13-512-256-128, 3 low-rank crosses of 3,456 x 512, over arch
    3456-1024-1024-512-256-1, Adagrad on the table and the towers) on a
    DCNV2_CAP-slot table: the main-path steps of DCNV2_PLAN with the launch
    counts set to 0 just before and read just after (kernels 1, 3 and 10
    must launch), then kernels 1, 3 and 10 on one more step's own calls
    against their plain versions, on a new batch (the lookup's miss
    branch) and on that batch again (its all-hit branch)."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.models import dlrm_dcnv2
    from recommenders_addons_tpu_torch.tools import fused_sweep as fs

    model = dlrm_dcnv2.DLRMDCNv2(
        dlrm_dcnv2.DLRMDCNv2Config(table_capacity=DCNV2_CAP), device=dev)
    cfg = model.cfg
    state = model.init(seed)
    state = dataclasses.replace(
        state, table=de.create_slots(model.var, state.table, model.opt))
    train_step, tx = model.make_train_step()
    opt_state = [tx.init(list(state.dense.parameters()))]
    rng = np.random.default_rng(seed)
    batches = [_on(torch, _dcnv2_batch(rng, cfg.multi_hot_sizes), dev)
               for _ in range(max(DCNV2_PLAN) + 2)]
    holder = [state]

    def step(batch):
        holder[0], opt_state[0], loss = train_step(holder[0], opt_state[0],
                                                   batch)
        return loss

    cuda_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(batches[i])) for i in DCNV2_PLAN]
    wall_s = time.perf_counter() - t0
    launches = _launched(cuda_ops, "(e) DLRM-DCNv2",
                         ("row_gather", "fused_update_scatter", "init_rows"),
                         "models")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"DLRM-DCNv2 losses not finite: {losses}")
    distinct = [int(torch.unique(model.bags(b["sparse"]).values).numel())
                for b in batches]
    out = {"config": "DLRMDCNv2Config() at MLPerf's widths, table "
                     f"{DCNV2_CAP} slots + Adagrad accumulator, f32",
           "batch": DCNV2_BATCH, "positions": DCNV2_BATCH
           * cfg.ids_per_example, "distinct_keys": distinct,
           "plan": list(DCNV2_PLAN), "losses": losses,
           "main_path_wall_s": wall_s, "launches": launches,
           "table_keys_after": int(model.var.size(holder[0].table))}
    new = batches[-1]
    for branch in ("miss", "hit"):
        inits = []

        def one_step():
            inits.extend(fs.record_calls(lambda: step(new), "init_rows"))

        own = _own_call_check(torch, cuda_ops, one_step, 1, 1,
                              f"DLRM-DCNv2 {branch} step")
        n_init = _own_init_rows_check(torch, cuda_ops, inits,
                                      f"DLRM-DCNv2 {branch} step")
        if n_init != (1 if branch == "miss" else 0):
            raise AssertionError(f"the DLRM-DCNv2 {branch} step called "
                                 f"init_rows {n_init} times")
        out[branch] = dict(own, init_rows_own_calls=n_init)
        del inits
        torch.cuda.empty_cache()
    del holder, batches
    torch.cuda.empty_cache()
    return out


def models_phase(torch, cuda_ops, dev, seed):
    """Phase 6: the model families on the sparse lookup API. (a) DCNConfig()
    at full width, 20 steps of 4,096 through train_loop, then a check of
    kernels 1 and 3 on one step's own calls; (b) a narrow DCN on card and
    CPU; (c) the sparse API at DCN's table width, card against CPU; (d)
    the JAX tests' learning bars; (e) DLRM-DCNv2 at MLPerf's widths, then
    kernels 1, 3 and 10 on its step's own calls. Launch counts reset
    before (a), (c), (d) and (e)."""
    from recommenders_addons_tpu_torch.models import dcn

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on: the DCN checks "
                             "hold float32 products")
    # (a) the main path; 6 more batches: the sync count, the trace (a
    # warm-up and 3) and the kernels' own-operand check
    dcn_out, losses, one_step = _train_full_width(
        torch, cuda_ops, dev, dcn.DCN(dcn.DCNConfig()), seed, DCN_STEPS, 6,
        "models (a) DCN")
    bad = [i for i, v in losses.items() if not math.isfinite(v)]
    if bad or len(losses) != DCN_STEPS:
        raise AssertionError(f"DCN losses not finite at steps {bad}: "
                             f"{losses}")

    dcn_out.update(
        config="DCNConfig() (26 sparse + 13 dense features, dim 32, 3 cross "
               "layers 845 x 845, deep 845-256-128, head 973-1; table 4Mi "
               "slots + Adagrad accumulator, f32)",
        **_own_call_check(torch, cuda_ops, one_step, 1, 2, "DCN step"))
    del one_step
    torch.cuda.empty_cache()
    return {"dcn": dcn_out,
            "narrow_dcn": _narrow_reference(torch, dev, seed, "dcn"),
            "sparse_api": _sparse_api_part(torch, cuda_ops, dev, seed),
            "learning_bars": _learning_bars(torch, cuda_ops),
            "dcnv2": _dcnv2_part(torch, cuda_ops, dev, seed)}


def _per_key(torch, var, st):
    """A table's live rows (a sharded table's, over all its shards) sorted
    by key, on its device: keys, scores and the used columns (value and
    slot words) as int32 words."""
    from recommenders_addons_tpu_torch.ops import hashtable

    keys, scores, rows = [], [], []
    for part in getattr(st, "shards", [st]):
        idx = torch.nonzero(hashtable.occupancy_mask(var.spec,
                                                     part)).reshape(-1)
        w = part.dim * (1 + len(part.slot_names))
        keys.append(part.keys[idx])
        scores.append(part.scores[idx])
        rows.append(part.rows_logical[idx, :w])
    keys, order = torch.sort(torch.cat(keys))
    rows = torch.cat(rows)[order].contiguous()
    return {"keys": keys, "scores": torch.cat(scores)[order],
            "rows": rows.view(torch.int32) if rows.dtype == torch.float32
            else rows.view(torch.int16)}


def _same_per_key(torch, a, b, what):
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differ key by key")


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _lifecycle_checkpoint(torch, dev, seed, tmp):
    """(a) The DLRM round trip: train DLRMConfig() LIFE_DLRM_STEPS steps,
    DECheckpoint the table, towers and tower optimizer state, restore
    into a fresh DLRM, hold the per-key export bit-equal, take
    LIFE_EXTRA_STEPS more steps from both (losses within LIFE_LOSS_RTOL),
    and hold the card's files byte-equal to a CPU copy's."""
    import filecmp
    import os

    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.models import dlrm
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt_lib

    def fresh(s):
        model = dlrm.DLRM(dlrm.DLRMConfig())
        st = model.init(s)
        st.table = de.create_slots(model.var, st.table, model.opt)
        step, tx = model.make_train_step()
        return model, st, step, tx.init(list(st.dense.parameters()))

    rng = np.random.default_rng(seed)
    batches = [_on(torch, dlrm.synthetic_criteo_batch(rng, DLRM_BATCH), dev)
               for _ in range(LIFE_DLRM_STEPS + LIFE_EXTRA_STEPS)]
    model, st, step, opt = fresh(seed)
    for b in batches[:LIFE_DLRM_STEPS]:
        st, opt, loss = step(st, opt, b)
    float(loss)  # the steps are done
    ckpt = ckpt_lib.DECheckpoint(table=model.var, dense=None, opt=None)
    card_dir = os.path.join(tmp, "card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(card_dir, {"table": st.table, "dense": st.dense, "opt": opt},
              step=LIFE_DLRM_STEPS)
    torch.cuda.synchronize()
    save_ms = (time.perf_counter() - t0) * 1e3
    written = _dir_bytes(card_dir)
    live = int(model.var.size(st.table))

    # the same table saved from a CPU copy (the plain gather)
    cpu_dir = os.path.join(tmp, "cpu")
    cpu_table = st.table.replace(**{f: getattr(st.table, f).cpu() for f in
                                    ("key_lo", "key_hi", "rows", "scores")})
    ckpt_lib.save_dynamic_embedding(model.var, cpu_table, cpu_dir,
                                    global_step=LIFE_DLRM_STEPS)
    del cpu_table
    sub = os.path.join(f"{ckpt_lib.DE_DIR_NAME}-{LIFE_DLRM_STEPS}",
                       model.var.name)
    names = sorted(os.listdir(os.path.join(cpu_dir, sub)))
    if sorted(os.listdir(os.path.join(card_dir, sub))) != names:
        raise AssertionError("lifecycle (a): card and CPU saves wrote "
                             "different files")
    same, diff, err = filecmp.cmpfiles(os.path.join(card_dir, sub),
                                       os.path.join(cpu_dir, sub), names,
                                       shallow=False)
    if diff or err:
        raise AssertionError(f"lifecycle (a): files differ card vs CPU: "
                             f"{diff + err}")

    model2, st2, step2, opt2 = fresh(seed + 1)
    st2.table = model2.var.init()  # the restore adds the slot column
    ckpt2 = ckpt_lib.DECheckpoint(table=model2.var, dense=None, opt=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ckpt2.restore(card_dir, {"table": st2.table, "dense": st2.dense,
                                   "opt": opt2})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _same_per_key(torch, _per_key(torch, model2.var, out["table"]),
                  _per_key(torch, model.var, st.table), "lifecycle (a)")
    for a, b in zip(out["dense"].state_dict().values(),
                    st.dense.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError("lifecycle (a): dense towers differ")
    if not all(torch.equal(a, b) for a, b in zip(out["opt"], opt)):
        raise AssertionError("lifecycle (a): tower optimizer state differs")
    st2 = dlrm.DLRMState(table=out["table"], dense=out["dense"],
                         step=st.step)
    opt2 = out["opt"]
    gaps = []
    for b in batches[LIFE_DLRM_STEPS:]:
        st, opt, l1 = step(st, opt, b)
        st2, opt2, l2 = step2(st2, opt2, b)
        l1, l2 = float(l1), float(l2)
        gaps.append(abs(l1 - l2))
        if not abs(l1 - l2) <= LIFE_LOSS_RTOL * abs(l1):
            raise AssertionError(f"lifecycle (a): losses after the restore "
                                 f"{l1} and {l2}")
    return {"config": "DLRMConfig() (dim 64, 4Mi slots, Adagrad), batch "
                      f"{DLRM_BATCH}, {LIFE_DLRM_STEPS} steps, then "
                      f"{LIFE_EXTRA_STEPS} from the original and from the "
                      "restore",
            "live_keys": live, "save_ms": save_ms,
            "bytes_written": written, "gb_written": written / 1e9,
            "restore_ms": restore_s * 1e3, "restore_keys_per_s":
            live / restore_s, "files": names,
            "card_vs_cpu_files_identical": len(same),
            "extra_step_loss_max_gap": max(gaps),
            "loss_rtol": LIFE_LOSS_RTOL}


def _survivors_check(torch, spec, before, after, num_reserved, what):
    """The survivors of a restriction are exactly numpy's top
    ``num_reserved`` live slots by (score, slot); their keys and scores
    unchanged."""
    from recommenders_addons_tpu_torch.ops import hashtable

    mask = hashtable.occupancy_mask(spec, before).cpu().numpy()
    sc = before.scores.cpu().numpy()
    live = np.flatnonzero(mask)
    order = live[np.lexsort((live, sc[live]))]
    want = np.zeros_like(mask)
    want[order[len(order) - num_reserved:]] = True
    got = hashtable.occupancy_mask(spec, after).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: survivors differ from numpy's top "
                             f"{num_reserved} in {int((got != want).sum())} "
                             f"slots")
    for f in ("key_lo", "key_hi", "scores"):
        a = getattr(after, f).cpu().numpy()[want]
        if not np.array_equal(a, getattr(before, f).cpu().numpy()[want]):
            raise AssertionError(f"{what}: survivors' {f} changed")


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _lifecycle_table(torch, dev, seed):
    """(b) restrict, (c) grow and (d) the chunked export at the table
    step's width: dim 64, LIFE_CAP slots, Adam slots (1 KiB rows)."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.ops import hashtable

    rng = np.random.default_rng(seed + 2)
    keys = np.unique(rng.integers(1, 1 << 62, size=LIFE_N + LIFE_N // 64))
    keys = rng.permutation(keys)[:LIFE_N].astype(np.int64)
    scores = (rng.permutation(LIFE_N) // 4).astype(np.int32)  # ties of 4
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rows():
        return torch.randn((LIFE_N, DIM), device=dev, generator=gen)

    lru = de.Variable(name="life_table", dim=DIM, init_capacity=LIFE_CAP,
                      evict_strategy=de.EvictStrategy.LRU)
    lfu = dataclasses.replace(lru, evict_strategy=de.EvictStrategy.LFU)
    st = de.create_slots(lru, lru.init(), de.Adam(0.001))
    st = lru.import_batch(st, torch.from_numpy(keys).to(dev), rows(),
                          scores=torch.from_numpy(scores).to(dev),
                          slot_rows={nm: rows() for nm in st.slot_names})
    live = int(lru.size(st))
    out = {"config": f"dim {DIM}, {LIFE_CAP} slots, Adam slots (1 KiB "
                     f"rows), {LIFE_N} keys imported, int32 scores from a "
                     "seeded permutation // 4", "live": live}

    # (b) the two policies, and lowest_k_indices against numpy
    for name, var, policy in (
            ("timestamp", lru, de.TimestampRestrictPolicy),
            ("frequency", lfu, de.FrequencyRestrictPolicy)):
        got, ms = _timed(torch, lambda: policy(var).apply_restriction(
            st, LIFE_RESERVED))
        _survivors_check(torch, var.spec, st, got, LIFE_RESERVED,
                         f"lifecycle (b) {name}")
        out[f"restrict_{name}_ms"] = ms
        del got
    idx, valid = hashtable.lowest_k_indices(
        st.scores, hashtable.occupancy_mask(lru.spec, st), LIFE_LOWEST_K)
    mask = hashtable.occupancy_mask(lru.spec, st).cpu().numpy()
    sc = st.scores.cpu().numpy()
    lv = np.flatnonzero(mask)
    want = np.sort(lv[np.lexsort((lv, sc[lv]))][:LIFE_LOWEST_K])
    if not (np.array_equal(idx.cpu().numpy(), want) and bool(valid.all())):
        raise AssertionError("lifecycle (b): lowest_k_indices differs from "
                             "numpy")

    # (c) grow to LIFE_GROW slots: per key bit-equal, and every key found
    before = _per_key(torch, lru, st)
    (gvar, grown), out["grow_ms"] = _timed(
        torch, lambda: lru.grow(st, LIFE_GROW))
    del st
    torch.cuda.empty_cache()
    _same_per_key(torch, _per_key(torch, gvar, grown), before,
                  "lifecycle (c) grow")
    vals, found = gvar.lookup(grown, before["keys"], return_exists=True)
    if not bool(found.all()):
        raise AssertionError("lifecycle (c): a key was not found after grow")
    if not torch.equal(vals.view(torch.int32),
                       before["rows"][:, :DIM].contiguous()):
        raise AssertionError("lifecycle (c): looked-up rows differ")
    out["grown_capacity"] = grown.capacity

    # (d) the chunked export equals the export
    parts, out["export_chunked_ms"] = _timed(
        torch, lambda: list(gvar.export_chunked(grown, LIFE_SPLIT)))
    k, v, m = gvar.export(grown)
    s = grown.scores[m]
    for i, (a, b) in enumerate(((k[m], 0), (v[m], 1), (s, 2))):
        got = torch.cat([p[b] for p in parts])
        if not torch.equal(got, a.cpu()):
            raise AssertionError(f"lifecycle (d): export_chunked column {i} "
                                 "differs from the export")
    out["export_chunks"] = len(parts)
    return out


def lifecycle_phase(torch, cuda_ops, dev, seed):
    """Phase 7: the table lifecycle at full width, launch counts reset
    first: (a) the DLRM checkpoint round trip, (b) the restrict policies,
    (c) grow, (d) the chunked export. row_gather, row_scatter and
    fused_update_scatter must have launched."""
    import shutil

    cuda_ops.reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    try:
        ckpt = _lifecycle_checkpoint(torch, dev, seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    table = _lifecycle_table(torch, dev, seed)
    launches = _launched(cuda_ops, "", ("row_gather", "row_scatter",
                                        "fused_update_scatter"),
                         phase="lifecycle")
    torch.cuda.empty_cache()
    return {"checkpoint": ckpt, "table": table, "launches": launches}


def _rows_agree(torch, got, want, what):
    """Two f32 tables' ``_per_key``: the same keys and scores, rows within
    SHARD_RTOL / SHARD_ATOL. Returns (max |row difference|, bit-equal)."""
    if not torch.equal(got["keys"], want["keys"]):
        raise AssertionError(f"{what}: the live keys differ "
                             f"({got['keys'].numel()} vs "
                             f"{want['keys'].numel()})")
    if not torch.equal(got["scores"], want["scores"]):
        raise AssertionError(f"{what}: scores differ")
    a, b = got["rows"].view(torch.float32), want["rows"].view(torch.float32)
    err = float((a - b).abs().max()) if a.numel() else 0.0
    if not torch.allclose(a, b, rtol=SHARD_RTOL, atol=SHARD_ATOL):
        raise AssertionError(f"{what}: rows differ by {err}")
    return err, bool(torch.equal(got["rows"], want["rows"]))


def _record_lookups(sv, keep=lambda ctx: ctx):
    """Wrap ``sv.embedding_lookup`` to keep ``keep(ctx)`` of each call."""
    ctxs = []
    inner = sv.embedding_lookup

    def recording(*a, **kw):
        emb, ctx = inner(*a, **kw)
        ctxs.append(keep(ctx))
        return emb, ctx

    object.__setattr__(sv, "embedding_lookup", recording)
    return ctxs


def _dlrm_run(torch, model, seed, batches):
    """``len(batches)`` DLRM steps from ``model.init(seed)`` (Adagrad slots
    made first): the final state and the losses."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    state = model.init(seed)
    state.table = de.create_slots(model.var, state.table, model.opt)
    step, tx = model.make_train_step()
    opt = tx.init(list(state.dense.parameters()))
    losses = []
    for b in batches:
        state, opt, loss = step(state, opt, b)
        losses.append(float(loss))
    return state, losses


def _exchange_share(torch, one_step, iters=3):
    """The exchange's share of the device time of ``iters`` steps, from
    the torch.profiler ranges the exchange runs in (None when the trace
    holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from recommenders_addons_tpu_torch.parallel.mesh import EXCHANGE_RANGE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            one_step()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA)
    # the range's host-side entry: its device time is that of the kernels
    # launched inside it (the trace's device-side copy of the range would
    # count them twice)
    ranges = [e for e in avg if e.key == EXCHANGE_RANGE
              and e.device_type == DeviceType.CPU]
    ex = sum(e.device_time_total for e in ranges)
    calls = sum(e.count for e in ranges)
    if not busy or not ex:
        return None, None, calls // iters
    return ex / busy, ex / iters / 1e3, calls // iters


def _sharded_full_width(torch, cuda_ops, dev, seed, mesh):
    """(a) DLRMConfig() on a mesh of SHARDS logical shards of the card,
    DLRM_STEPS steps through train_loop (the main path), then the
    exchange's share of 3 more steps, then kernels 1 and 3 on one more
    step's own operands (every owner's fused apply and the owners' row
    gathers) against their plain versions."""
    from recommenders_addons_tpu_torch.models import dlrm
    from recommenders_addons_tpu_torch.ops import hashtable

    model = dlrm.DLRM(dlrm.DLRMConfig(), mesh=mesh)
    sv = model.params
    # each lookup's drops, retry flag and K (not its context: the owners'
    # packed rows are 0.1 GB a step)
    seen = _record_lookups(sv, lambda c: (
        torch.stack(c.num_dropped).sum(), c.deduped,
        c.octx[0].unique_keys.shape[0] // SHARDS))
    syncs0 = sv.stats["host_syncs"]
    out, losses, one_step = _train_full_width(
        torch, cuda_ops, dev, model, seed, DLRM_STEPS, 9, "sharded")
    first, last = losses[1], losses[DLRM_STEPS]
    if not (math.isfinite(first) and math.isfinite(last) and last < first):
        raise AssertionError(f"sharded DLRM loss {first} at step 1, {last} "
                             f"at step {DLRM_STEPS}: not finite and falling")
    # the routing's own syncs over every lookup so far (the main path,
    # the sync count's step, the trace's warm-up and 3)
    routing_syncs = (sv.stats["host_syncs"] - syncs0) / len(seen)
    main = seen[:DLRM_STEPS]
    share, ex_ms, calls = _exchange_share(torch, one_step)
    own = _own_call_check(torch, cuda_ops, one_step, SHARDS, SHARDS,
                          "sharded step")
    state = one_step.state()
    out.update({
        "shards": SHARDS,
        "num_dropped_sum": int(sum(d for d, _, _ in main)),
        "deduped_steps": sum(r for _, r, _ in main),
        "k_per_pair": main[0][2],
        "routing_host_syncs_per_step": routing_syncs,
        "live_keys_per_shard": [int(hashtable.size(sv.spec, st))
                                for st in state.table.shards],
        "exchange_share_of_device_time": share,
        "exchange_ms_per_step": ex_ms, "exchanges_per_step": calls,
        **own,
    })
    return model, state, out


def _sharded_vs_unsharded(torch, dev, seed, mesh):
    """(b) The same seed and batches, SHARD_CHECK_STEPS full-width steps,
    sharded and unsharded: the same live keys, per-key rows within
    SHARD_RTOL / SHARD_ATOL, the loss gap. Returns the check and the
    unsharded table's per-key rows and the batches, for (e)."""
    from recommenders_addons_tpu_torch.models import dlrm

    rng = np.random.default_rng(seed + 1)
    batches = [_on(torch, dlrm.synthetic_criteo_batch(rng, DLRM_BATCH), dev)
               for _ in range(SHARD_CHECK_STEPS)]
    single = dlrm.DLRM(dlrm.DLRMConfig())
    st1, l1 = _dlrm_run(torch, single, seed, batches)
    want = _per_key(torch, single.var, st1.table)
    del st1
    sharded = dlrm.DLRM(dlrm.DLRMConfig(), mesh=mesh)
    st4, l4 = _dlrm_run(torch, sharded, seed, batches)
    got = _per_key(torch, sharded.var, st4.table)
    del st4
    err, same = _rows_agree(torch, got, want, "sharded vs unsharded")
    torch.cuda.empty_cache()
    return {"steps": SHARD_CHECK_STEPS, "live_keys": int(want["keys"].numel()),
            "rows_max_abs_err": err, "rows_bit_equal": same,
            "losses_sharded": l4, "losses_unsharded": l1,
            "loss_gap_max": max(abs(a - b) for a, b in zip(l4, l1)),
            "rtol": SHARD_RTOL, "atol": SHARD_ATOL}, want, batches


def _sharded_hot_keys(torch, dev, seed, mesh):
    """(c) tests/test_sharded.py's hot-key batch scaled to DLRM_BATCH ids
    on SHARDS shards: block 0 is one key DLRM_BATCH // SHARDS times (more
    than K), the others distinct keys. Every step must take the dedup
    retry and drop nothing; rows agree with one unsharded table."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch import parallel

    rng = np.random.default_rng(seed + 2)
    blk = DLRM_BATCH // SHARDS
    rest = rng.choice(1 << 40, size=DLRM_BATCH - blk, replace=False) + 100
    ids = torch.from_numpy(np.concatenate([np.full(blk, 7), rest]).astype(
        np.int64)).to(dev)
    grads = [torch.from_numpy(rng.normal(size=(DLRM_BATCH, DIM)).astype(
        np.float32)).to(dev) for _ in range(SHARD_CHECK_STEPS)]

    def var():
        return de.Variable(name="hot", dim=DIM, init_capacity=1 << 20,
                           initializer=de.initializers.normal(0.1))

    single, sv = var(), parallel.ShardedVariable(var(), mesh)
    opt = de.Adagrad(0.1)
    s1 = de.create_slots(single, single.init(), opt)
    s4 = sv.create_slots(sv.init(), opt)
    for t, g in enumerate(grads):
        _, ctx = single.embedding_lookup(s1, ids)
        s1 = single.apply_gradients(s1, ctx, g, opt, step=t)
        _, sctx = sv.embedding_lookup(s4, ids)
        dropped = int(torch.stack(sctx.num_dropped).sum())
        if not sctx.deduped or dropped:
            raise AssertionError(f"hot keys step {t}: deduped "
                                 f"{sctx.deduped}, {dropped} dropped")
        s4 = sv.apply_gradients(s4, sctx, g, opt, step=t)
    err, same = _rows_agree(torch, _per_key(torch, sv.var, s4),
                            _per_key(torch, single, s1), "hot keys")
    return {"batch": DLRM_BATCH, "hot_key_repeats": blk,
            "k_per_pair": int(sctx.octx[0].unique_keys.shape[0] // SHARDS),
            "deduped_steps": SHARD_CHECK_STEPS, "num_dropped": 0,
            "rows_max_abs_err": err, "rows_bit_equal": same}


def _sharded_card_vs_cpu(torch, dev, seed):
    """(d) The narrow DLRM (_narrow_reference's shape) on SHARDS shards of
    the card and of the CPU from the same weights and batches: per step
    the routing and owner planes (send_pos, routed, found, inserted, the
    received keys) and per shard the key and score planes bit-exact;
    losses within NARROW_RTOL / NARROW_ATOL, rows within SHARD_RTOL /
    SHARD_ATOL."""
    from recommenders_addons_tpu_torch import convert
    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.models import dlrm

    cfg = dlrm.DLRMConfig(num_sparse=4, dim=8, bottom_sizes=(16, 8),
                          top_sizes=(16, 1), table_capacity=1024)
    rng = np.random.default_rng(seed)
    batches = [dlrm.synthetic_criteo_batch(rng, 64, num_sparse=4,
                                           vocab_per_feature=400)
               for _ in range(3)]
    runs, weights = {}, None
    for where in ("cpu", dev):
        mesh = parallel.create_mesh(devices=[where] * SHARDS)
        model = dlrm.DLRM(cfg, mesh=mesh, device=where)
        ctxs = _record_lookups(model.params)
        state = model.init(seed)
        if weights is None:
            weights = convert.dlrm_dense_to_numpy(state.dense)
        state.dense = convert.dlrm_dense_from_numpy(weights, cfg,
                                                    device=where)
        state.table = model.params.create_slots(state.table, model.opt)
        step, tx = model.make_train_step()
        opt = tx.init(list(state.dense.parameters()))
        losses = []
        for b in batches:
            state, opt, loss = step(state, opt, _on(torch, b, where))
            losses.append(float(loss))
        runs[str(where)] = (losses, state.table, ctxs)
    (cl, ct, cc), (gl, gt, gc) = runs["cpu"], runs[str(dev)]
    if not np.allclose(gl, cl, rtol=NARROW_RTOL, atol=NARROW_ATOL):
        raise AssertionError(f"sharded narrow losses: card {gl}, CPU {cl}")
    planes = 0
    for t, (a, b) in enumerate(zip(gc, cc)):
        pairs = [("send_pos", a.send_pos, b.send_pos),
                 ("routed", a.routed, b.routed)]
        for f in ("found", "inserted", "unique_keys"):
            pairs.append((f, [getattr(o, f) for o in a.octx],
                          [getattr(o, f) for o in b.octx]))
        for name, xs, ys in pairs:
            for x, y in zip(xs, ys):
                planes += 1
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"sharded narrow step {t}: {name} "
                                         "differs card vs CPU")
    err = 0.0
    for i, (g, c) in enumerate(zip(gt.shards, ct.shards)):
        for f in ("key_lo", "key_hi", "scores"):
            planes += 1
            if not torch.equal(getattr(g, f).cpu(), getattr(c, f)):
                raise AssertionError(f"sharded narrow shard {i} {f}: card "
                                     "and CPU differ")
        a, b = g.rows_logical.cpu(), c.rows_logical
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=SHARD_RTOL, atol=SHARD_ATOL):
            raise AssertionError(f"sharded narrow shard {i} rows differ by "
                                 f"{err}")
    return {"steps": 3, "batch": 64, "losses_card": gl, "losses_cpu": cl,
            "integer_planes_bit_exact": planes, "rows_max_abs_err": err}


def _sharded_process_group(torch, dev, seed, want, batches):
    """(e) The process-group exchange on the card: NCCL, a world of one
    rank (a FileStore under a temporary directory; no network), S = 1, the
    full-width DLRM for (b)'s steps, per key against (b)'s unsharded
    table."""
    import shutil

    import torch.distributed as dist

    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.models import dlrm
    from recommenders_addons_tpu_torch.parallel import multihost

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    multihost.initialize(f"file://{tmp}/store", world_size=1, rank=0,
                         backend="nccl")
    try:
        mesh = multihost.global_mesh(device=dev)
        if not isinstance(mesh, parallel.GroupMesh):
            raise AssertionError(f"not a process-group mesh: {mesh}")
        model = dlrm.DLRM(dlrm.DLRMConfig(), mesh=mesh)
        state, losses = _dlrm_run(torch, model, seed, batches)
        got = _per_key(torch, model.var, state.table)
        del state
        err, same = _rows_agree(torch, got, want, "process group")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"backend": "nccl", "world_size": 1, "shards": 1,
            "steps": len(batches), "losses": losses,
            "rows_max_abs_err": err, "rows_bit_equal_to_unsharded": same}


def _sharded_checkpoint(torch, cuda_ops, model, state):
    """(f) (a)'s table saved as SHARDS shard file sets, restored into a
    fresh SHARDS-shard table (the direct path) and into one table: every
    key's rows (value and slot words), score and slot bit-equal to the
    saved. Launch counts set to 0 first: row_gather (the save's
    compaction) and row_scatter (the restores) must launch."""
    import os
    import shutil

    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    sv = model.params
    saved = _per_key(torch, sv.var, state)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    cuda_ops.reset_launches()
    try:
        t0 = time.perf_counter()
        vdir = ckpt.save_dynamic_embedding(sv, state, tmp)
        save_ms = (time.perf_counter() - t0) * 1e3
        files = sorted(f for f in os.listdir(vdir) if f.endswith("-keys"))
        if len(files) != SHARDS:
            raise AssertionError(f"sharded save wrote {files}")
        out = {"files": files, "bytes": _dir_bytes(tmp), "save_ms": save_ms,
               "live_keys": int(saved["keys"].numel())}
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        back = ckpt.load_dynamic_embedding(sv, sv.init(), tmp)
        torch.cuda.synchronize()
        out["restore_sharded_ms"] = (time.perf_counter() - t0) * 1e3
        if not ckpt.LAST_RESTORE_USED_DIRECT:
            raise AssertionError("the 4-shard restore took the streamed "
                                 "path, not the direct one")
        got = _per_key(torch, sv.var, back)
        _same_per_key(torch, got, saved, "sharded restore")
        del back, got
        torch.cuda.empty_cache()
        one = de.Variable(name=sv.var.name, dim=sv.var.dim,
                          init_capacity=sv.var.total_capacity)
        t0 = time.perf_counter()
        flat = ckpt.load_dynamic_embedding(one, one.init(), tmp)
        torch.cuda.synchronize()
        out["restore_unsharded_ms"] = (time.perf_counter() - t0) * 1e3
        got = _per_key(torch, one, flat)
        _same_per_key(torch, got, saved, "unsharded restore")
        del flat, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = _launched(cuda_ops, "", ("row_gather", "row_scatter"),
                                phase="sharded checkpoint")
    torch.cuda.empty_cache()
    return out


def sharded_phase(torch, cuda_ops, dev, seed):
    """Phase 8: the sharded table (parallel/) on SHARDS logical shards of
    the card: (a) the full-width DLRM's main path, (b) against the
    unsharded DLRM, (c) hot keys, (d) card against CPU, (e) the NCCL
    process-group exchange, (f) the sharded checkpoint."""
    from recommenders_addons_tpu_torch import parallel

    mesh = parallel.create_mesh(devices=[dev] * SHARDS)
    t0 = time.perf_counter()
    model, state, full = _sharded_full_width(torch, cuda_ops, dev, seed,
                                             mesh)
    torch.cuda.empty_cache()
    vs, want, batches = _sharded_vs_unsharded(torch, dev, seed, mesh)
    hot = _sharded_hot_keys(torch, dev, seed, mesh)
    card_cpu = _sharded_card_vs_cpu(torch, dev, seed)
    group = _sharded_process_group(torch, dev, seed, want, batches)
    ckpt = _sharded_checkpoint(torch, cuda_ops, model, state.table)
    return {"mesh": f"{SHARDS} logical shards of one card "
                    f"([cuda:0] * {SHARDS})",
            "config": "DLRMConfig() (dim 64, 26 features, 4Mi slots in all: "
                      f"{SHARDS} shards of {(C // SHARDS) >> 20}Mi + Adagrad "
                      "accumulator, f32)",
            "full_width": full, "vs_unsharded": vs, "hot_keys": hot,
            "card_vs_cpu": card_cpu, "process_group": group,
            "checkpoint": ckpt, "phase_s": time.perf_counter() - t0,
            "launches": {"sharded_training": full["launches"],
                         "sharded_checkpoint": ckpt["launches"]}}


def _spill_keys(seed, n) -> np.ndarray:
    """``n`` distinct non-negative int64 keys from the seed: a seeded
    offset times an odd constant, mod 2**62 (a bijection)."""
    off = np.random.default_rng(seed).integers(0, 1 << 40)
    with np.errstate(over="ignore"):
        k = (np.arange(n, dtype=np.int64) + off) * np.int64(
            -7046029254386353131)  # 0x9E3779B97F4A7C15 as int64
    return k & ((1 << 62) - 1)


def _spill_values(torch, keys, dim, seed):
    """Seeded rows as a function of each key (so any row can be checked
    again from its key alone): 24 bits of ``key * K + column * M + seed``,
    scaled to [-0.5, 0.5)."""
    col = torch.arange(dim, dtype=torch.int64, device=keys.device)
    h = keys[:, None] * -7046029254386353131 + col * 0x5851F42D4C957F2D + (
        seed * 0x2545F491)
    return ((h >> 40) & 0xFFFFFF).to(torch.float32) / (1 << 24) - 0.5


def _store_sorted(store):
    """A host store's export sorted by key: keys, scores and the value
    and slot columns side by side, as numpy."""
    keys, vals, scores, slots = store.export_all()
    order = np.argsort(keys, kind="stable")
    cols = np.concatenate([vals] + [slots[n] for n in sorted(slots)],
                          axis=1)
    return {"keys": keys[order], "scores": scores[order],
            "rows": cols[order].view(np.int32)}


def _same_store(a, b, what):
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: the stores' {k} differ")


def _hbm_keys(torch, var, st) -> np.ndarray:
    from recommenders_addons_tpu_torch.ops import hashtable

    parts = []
    for part in getattr(st, "shards", [st]):
        mask = hashtable.occupancy_mask(var.spec, part)
        parts.append(part.keys[mask].cpu().numpy())
    return np.concatenate(parts)


def _tiers_cover(torch, var, hy, keys, what):
    """The card's and the tier's key sets are disjoint and together are
    exactly ``keys``; returns (card keys, tier keys)."""
    on_card = _hbm_keys(torch, var, hy.state)
    in_tier = hy.tier.store.export_all()[0]
    both = np.sort(np.concatenate([on_card, in_tier]))
    if not np.array_equal(both, np.sort(keys)):
        raise AssertionError(
            f"{what}: {len(on_card)} card + {len(in_tier)} tier keys are "
            f"not the {len(keys)} keys, once each")
    return on_card, in_tier


def _row_bytes(var, n_slots=1) -> int:
    """Bytes of one row moved between the tiers: key, score, value and
    slot columns."""
    return 8 + 4 + var.dim * (1 + n_slots) * 4


def _spill_prefill(torch, var, hy, keys, seed, dev):
    """(a) Every key through HybridTable.upsert in SPILL_BLOCK blocks
    (LRU step = the block): bucket eviction absorbs the displaced rows
    into the tier. Checks total_keys, the tiers' cover and every row (of
    every shard) against its key's seeded value, bit for bit."""
    from recommenders_addons_tpu_torch.ops import hashtable

    n = len(keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, off in enumerate(range(0, n, SPILL_BLOCK)):
        k = torch.from_numpy(keys[off:off + SPILL_BLOCK]).to(dev)
        hy.upsert(k, _spill_values(torch, k, var.dim, seed), step=b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    total = hy.tier.total_keys(hy.state)
    if total != n:
        raise AssertionError(f"prefill: total_keys {total}, not {n}")
    on_card, in_tier = _tiers_cover(torch, var, hy, keys, "prefill")
    for st in getattr(hy.state, "shards", [hy.state]):
        mask = hashtable.occupancy_mask(var.spec, st)
        if not torch.equal(st.values[mask], _spill_values(
                torch, st.keys[mask], var.dim, seed)):
            raise AssertionError("prefill: a card row is not its upserted "
                                 "value")
    fill = dict(hy.state.slot_inits)["accumulator"]
    tk, tv, _, tsl = hy.tier.store.export_all()
    tk = torch.from_numpy(tk).to(dev)
    if not torch.equal(torch.from_numpy(tv).to(dev),
                       _spill_values(torch, tk, var.dim, seed)):
        raise AssertionError("prefill: a tier row is not its upserted value")
    if not bool((torch.from_numpy(tsl["accumulator"]) == fill).all()):
        raise AssertionError("prefill: a tier row's accumulator is not its "
                             "fresh fill")
    absorbed = hy.tier.stats.demoted
    return {"keys": n, "blocks": -(-n // SPILL_BLOCK), "ms": ms,
            "card_keys": len(on_card), "tier_keys": len(in_tier),
            "rows_absorbed": absorbed,
            "host_gb_per_s": absorbed * _row_bytes(var) / (ms * 1e6)}


def _zipf_ids(rng, keys, perm, n):
    r = np.minimum(rng.zipf(1.2, size=n) - 1, len(keys) - 1)
    return keys[perm[r]]


def _spill_step(torch, de, var, hy, opt, ids, grads, step, dev,
                record=None):
    """One training step through the tier: promote, the watermark (what
    ``prepare_batch`` does), the batch keys still missing, then
    ``embedding_lookup`` and the tier's apply; timed part by part.
    ``record`` (a dict) receives the operands of the promote's row
    scatter and of the demote's row gather."""
    from recommenders_addons_tpu_torch.ops import hashtable
    from recommenders_addons_tpu_torch.tools import fused_sweep as fs

    s0 = dataclasses.replace(hy.tier.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def promote():
        hy.state = hy.tier.promote(hy.state, ids)

    def demote():
        hy.state = hy.tier.demote_to_watermark(hy.state, hy.high, hy.low)

    def prepare():
        if record is None:
            promote()
        else:
            record["scatter"] = fs.record_calls(
                promote, "scatter_rows_set_2d", limit=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s_mid = dataclasses.replace(hy.tier.stats)
        if record is None:
            demote()
        else:
            record["gather"] = fs.record_calls(demote, "gather_rows_2d",
                                               limit=1)
        torch.cuda.synchronize()
        return t1, time.perf_counter(), s_mid

    (t1, t2, sm), syncs = _count_syncs(torch, prepare)
    s1 = dataclasses.replace(hy.tier.stats)
    uniq = torch.unique(torch.from_numpy(ids).to(dev))
    svar = getattr(hy.tier, "svar", None)
    if svar is not None:
        missing = int((~svar.contains(hy.state, uniq)).sum())
    else:
        missing = int((~hashtable.find(var.spec, hy.state, uniq)[1]).sum())
    ids_dev = torch.from_numpy(ids).to(dev)
    owner = svar or var

    def train():
        emb, ctx = owner.embedding_lookup(hy.state, ids_dev, step=step)
        hy.state = hy.tier.apply_gradients(hy.state, ctx, grads, opt,
                                           step=step)
        torch.cuda.synchronize()

    t3 = time.perf_counter()
    _, syncs2 = _count_syncs(torch, train)
    t4 = time.perf_counter()
    promoted = sm.promoted - s0.promoted
    demoted = s1.demoted - sm.demoted
    rb = _row_bytes(var)
    promote_ms, demote_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    return {"promote_ms": promote_ms, "demote_ms": demote_ms,
            "lookup_apply_ms": (t4 - t3) * 1e3,
            "ms": (t2 - t0 + t4 - t3) * 1e3,
            "promoted": promoted, "demoted": demoted,
            "absorbed_by_promote": sm.demoted - s0.demoted,
            "absorbed_by_apply": hy.tier.stats.demoted - s1.demoted,
            "missing_after_prepare": missing,
            "host_syncs": syncs + syncs2,
            "promote_gb_per_s": promoted * rb / (promote_ms * 1e6),
            "demote_gb_per_s": (demoted * rb / (demote_ms * 1e6)
                                if demoted else None)}


def _promote_loop_ms(hit_keys) -> float:
    """The time of promote's kept Python loop (``placed = [k for k in
    hit_keys.tolist() if k not in not_placed]``) over ``hit_keys``."""
    t0 = time.perf_counter()
    not_placed: set = set()
    np.asarray([k for k in hit_keys.tolist() if k not in not_placed],
               np.int64)
    return (time.perf_counter() - t0) * 1e3


def _spill_training(torch, cuda_ops, de, var, hy, opt, keys, seed, dev):
    """(b) SPILL_STEPS steps of SPILL_BATCH zipf(1.2) ids over a seeded
    permutation of the keys through the tier. The first step's demote
    row gather and promote import scatter are recorded (copies of the
    table: its time includes them) and held against their plain
    versions after the steps (bit-exact)."""
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(keys))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batches = [_zipf_ids(rng, keys, perm, SPILL_BATCH)
               for _ in range(SPILL_STEPS)]
    grads = [torch.randn((SPILL_BATCH, var.dim), device=dev, generator=gen)
             for _ in range(SPILL_STEPS)]
    steps, rec = [], {}
    cuda_ops.reset_launches()
    for i, ids in enumerate(batches):
        steps.append(_spill_step(torch, de, var, hy, opt, ids, grads[i],
                                 i + 1, dev, rec if i == 0 else None))
    launches = _launched(cuda_ops, "(b)", ("row_gather", "row_scatter",
                                           "fused_update_scatter"), "spill")
    if len(rec["gather"]) != 1 or len(rec["scatter"]) != 1:
        raise AssertionError("spill (b): the first step did not demote "
                             "and promote")
    big = rec["gather"][0]
    g_err = _same_bits(torch, cuda_ops.gather_rows_2d(**big),
                       cuda_ops.gather_rows_2d_plain(**big))
    s = rec["scatter"][0]
    got = s["table2d"].clone()
    cuda_ops.scatter_rows_set_2d(**dict(s, table2d=got))
    want = cuda_ops.scatter_rows_set_2d_plain(**dict(
        s, table2d=s["table2d"].clone()))
    cap = s["cap"] if s["cap"] is not None else None
    n = (cap * s["ch"]) if cap else got.shape[0] - s["ch"]
    s_err = _same_bits(torch, got[:n], want[:n])
    if g_err or s_err:
        raise AssertionError(f"spill (b) own operands: demote gather "
                             f"{g_err} apart, promote scatter {s_err}")
    demote_rows = int(big["idx"].numel())
    del rec, got, want, big, s
    torch.cuda.empty_cache()
    ms = [st["ms"] for st in steps]
    hot = np.unique(batches[-1])
    return {"steps": steps, "launches": launches,
            "ms_per_step_median": float(np.median(ms)),
            "missing_after_prepare_sum": sum(
                st["missing_after_prepare"] for st in steps),
            "promote_loop_ms_at_batch_unique": _promote_loop_ms(hot),
            "batch_unique_keys": len(hot),
            "own_operands": {"demote_row_gather_rows": demote_rows,
                             "demote_row_gather_max_abs_err": g_err,
                             "promote_row_scatter_max_abs_err": s_err},
            "total_keys_after": hy.tier.total_keys(hy.state)}


def _narrow_run(torch, de, where, seed):
    """The spill sequence at SPILL_NARROW (dim, slots, keys) on one
    device: the prefill in 8 blocks, then 5 steps of 1,024 zipf ids."""
    from recommenders_addons_tpu_torch.ops.spill import HybridTable

    dim, cap, n = SPILL_NARROW
    var = de.Variable(name="spill_narrow", dim=dim, init_capacity=cap,
                      evict_strategy=de.EvictStrategy.LRU, device=where)
    opt = de.Adagrad(0.1)
    hy = HybridTable(var, SPILL_HIGH, SPILL_LOW)
    hy.state = de.create_slots(var, hy.state, opt)
    keys = _spill_keys(seed + 3, n)
    rng = np.random.default_rng(seed + 3)
    vals = rng.normal(size=(n, dim)).astype(np.float32)
    blk = n // 8
    for b in range(8):
        sl = slice(b * blk, (b + 1) * blk)
        hy.upsert(torch.from_numpy(keys[sl]).to(where),
                  torch.from_numpy(vals[sl]).to(where), step=b)
    perm = rng.permutation(n)
    for t in range(5):
        ids = _zipf_ids(rng, keys, perm, 1024)
        hy.prepare_batch(ids)
        _, ctx = var.embedding_lookup(hy.state,
                                      torch.from_numpy(ids).to(where),
                                      step=10 + t)
        g = torch.from_numpy(rng.normal(size=(1024, dim)).astype(
            np.float32)).to(where)
        hy.state = hy.tier.apply_gradients(hy.state, ctx, g, opt,
                                           step=10 + t)
    st = hy.state
    planes = {f: getattr(st, f).cpu() for f in ("key_lo", "key_hi",
                                                 "scores")}
    planes["rows"] = st.rows[:st.capacity * st.chunks].cpu().view(
        torch.int32)
    return planes, _store_sorted(hy.tier.store), vars(hy.tier.stats)


def _spill_narrow(torch, de, dev, seed):
    """(c) The narrow sequence on the card and on the CPU: key planes and
    scores bit-exact, the stores' keys and scores bit-exact, the
    SpillStats equal; the rows the optimizer trained (the table's and
    the store's value and slot columns) within SURFACE_RTOL /
    SURFACE_ATOL, since the grad combine's f64 prefix sums are taken in
    another order on the card (as in the sharded phase's (d))."""
    card = _narrow_run(torch, de, dev, seed)
    cpu = _narrow_run(torch, de, "cpu", seed)
    for f in ("key_lo", "key_hi", "scores"):
        if not torch.equal(card[0][f], cpu[0][f]):
            raise AssertionError(f"spill (c): {f} differ card vs CPU")
    for k in ("keys", "scores"):
        if not np.array_equal(card[1][k], cpu[1][k]):
            raise AssertionError(f"spill (c): the stores' {k} differ")
    if card[2] != cpu[2]:
        raise AssertionError(f"spill (c): stats {card[2]} vs {cpu[2]}")
    table_err = _rows_close(torch, card[0]["rows"].view(torch.float32),
                            cpu[0]["rows"].view(torch.float32),
                            "spill (c) table rows")
    store_err = _rows_close(
        torch, torch.from_numpy(card[1]["rows"].view(np.float32)),
        torch.from_numpy(cpu[1]["rows"].view(np.float32)),
        "spill (c) store rows")
    dim, cap, n = SPILL_NARROW
    return {"dim": dim, "slots": cap, "keys": n, "stats": card[2],
            "tier_keys": int(len(card[1]["keys"])),
            "table_rows_max_abs_err": table_err,
            "store_rows_max_abs_err": store_err,
            "rows_bit_equal": bool(
                torch.equal(card[0]["rows"], cpu[0]["rows"])
                and np.array_equal(card[1]["rows"], cpu[1]["rows"]))}


class _CallTimer:
    """Wraps ``module.<name>`` for a ``with`` block and sums its calls'
    wall time (ms)."""

    def __init__(self, module, name):
        self.module, self.name, self.ms = module, name, 0.0

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _spill_checkpoint(torch, cuda_ops, de, var, hy, opt, tmp):
    """(d) save_dynamic_embedding(..., tier=hy), then a cold restore into
    a fresh HybridTable: every key of each tier bit-equal (rows, score,
    slot). Save and restore ms and GB for each tier (the tier's part
    timed around save_tier / load_tier)."""
    import os

    from recommenders_addons_tpu_torch.ops.spill import HybridTable
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    saved_card = _per_key(torch, var, hy.state)
    saved_tier = _store_sorted(hy.tier.store)
    cuda_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _CallTimer(ckpt, "save_tier") as tsave:
        vdir = ckpt.save_dynamic_embedding(var, hy.state, tmp, tier=hy)
    save_ms = (time.perf_counter() - t0) * 1e3
    tier_bytes = _dir_bytes(os.path.join(vdir, "tier"))
    card_bytes = _dir_bytes(vdir) - tier_bytes
    hy2 = HybridTable(var, SPILL_HIGH, SPILL_LOW)
    hy2.state = de.create_slots(var, hy2.state, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _CallTimer(ckpt, "load_tier") as tload:
        hy2.state = ckpt.load_dynamic_embedding(var, hy2.state, tmp,
                                                tier=hy2)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    launches = _launched(cuda_ops, "(d)", ("row_gather", "row_scatter"),
                         "spill")
    _same_per_key(torch, _per_key(torch, var, hy2.state), saved_card,
                  "spill (d) card tier restore")
    _same_store(_store_sorted(hy2.tier.store), saved_tier,
                "spill (d) host tier restore")
    out = {"card": {"keys": int(saved_card["keys"].numel()),
                    "gb": card_bytes / 1e9,
                    "save_ms": save_ms - tsave.ms,
                    "restore_ms": restore_ms - tload.ms},
           "tier": {"keys": int(len(saved_tier["keys"])),
                    "gb": tier_bytes / 1e9, "save_ms": tsave.ms,
                    "restore_ms": tload.ms},
           "launches": launches}
    del hy2, saved_card
    torch.cuda.empty_cache()
    return out


def _spill_serving(torch, cuda_ops, de, var, hy, keys, seed, dev):
    """(e) lookup_through of SPILL_BATCH ids (card hits, tier hits,
    unknown keys) and EmbeddingServer(tiers=) over freeze(..., float32):
    SPILL_REQUESTS checked and SPILL_TIMED timed requests of 256 x 26
    ids, each bit-equal to a numpy reference from the two tiers' exports
    (the card's row first, then the tier's, then the default 0)."""
    from recommenders_addons_tpu_torch.ops import hashtable
    from recommenders_addons_tpu_torch.serving import (
        EmbeddingClient,
        EmbeddingServer,
    )

    st = hy.state
    mask = hashtable.occupancy_mask(var.spec, st)
    ck = st.keys[mask].cpu().numpy()
    cv = st.values[mask].cpu().numpy()
    co = np.argsort(ck)
    ck, cv = ck[co], cv[co]
    tk, tv, _, _ = hy.tier.store.export_all()
    to = np.argsort(tk)
    tk, tv = tk[to], tv[to]

    def reference(q):
        out = np.zeros((len(q), var.dim), np.float32)
        found = np.zeros(len(q), bool)
        for k, v in ((tk, tv), (ck, cv)):  # the card's row wins
            pos = np.minimum(np.searchsorted(k, q), len(k) - 1)
            hit = k[pos] == q
            out[hit] = v[pos[hit]]
            found |= hit
        return out, found

    rng = np.random.default_rng(seed + 5)
    unknown = (1 << 62) + np.arange(SPILL_BATCH // 8, dtype=np.int64)
    q = np.concatenate([rng.choice(ck, SPILL_BATCH * 3 // 8),
                        rng.choice(tk, SPILL_BATCH // 2), unknown])
    q = q[rng.permutation(len(q))]
    cuda_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = hy.tier.lookup_through(st, torch.from_numpy(q).to(dev))
    torch.cuda.synchronize()
    lt_ms = (time.perf_counter() - t0) * 1e3
    want, found = reference(q)
    if not np.array_equal(got.cpu().numpy().view(np.int32),
                          want.view(np.int32)):
        raise AssertionError("spill (e): lookup_through differs from the "
                             "reference")
    frozen = de.freeze(var, st, dtype=torch.float32)
    perm = rng.permutation(len(keys))
    reqs = []
    for _ in range(SPILL_REQUESTS + SPILL_TIMED):
        ids = _zipf_ids(rng, keys, perm, 256 * FEATURES)
        ids[::97] = (1 << 62) + rng.integers(0, 1 << 20, len(ids[::97]))
        reqs.append(ids)
    times = []
    with EmbeddingServer({"emb": frozen}, tiers={"emb": hy.tier},
                         port=0) as srv:
        cli = EmbeddingClient(srv.host, srv.port)
        for i, r in enumerate(reqs):
            t0 = time.perf_counter()
            vals, fnd = cli.lookup("emb", r)
            times.append((time.perf_counter() - t0) * 1e3)
            if i < SPILL_REQUESTS:
                w, wf = reference(r)
                if not (np.array_equal(fnd, wf) and np.array_equal(
                        vals.view(np.int32), w.view(np.int32))):
                    raise AssertionError(f"spill (e): request {i} differs "
                                         "from the reference")
    launches = _launched(cuda_ops, "(e)", ("row_gather",), "spill")
    timed = times[SPILL_REQUESTS:]
    del frozen
    torch.cuda.empty_cache()
    return {"lookup_through_ids": len(q), "lookup_through_ms": lt_ms,
            "lookup_through_found": int(found.sum()),
            "served_from_tier": hy.tier.stats.served_from_tier,
            "requests_checked": SPILL_REQUESTS,
            "request_ms_p50": float(np.median(timed)),
            "request_ms_max": float(np.max(timed)),
            "ids_per_request": 256 * FEATURES, "launches": launches}


def _spill_sharded(torch, cuda_ops, de, dev, keys, seed):
    """(f1) A ShardedSpillTier on SHARDS logical shards of the card
    (DLRMConfig()'s table, split): (a)'s prefill, then
    SPILL_SHARDED_STEPS steps."""
    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.ops import hashtable
    from recommenders_addons_tpu_torch.ops.spill import HybridTable

    mesh = parallel.create_mesh(devices=[dev] * SHARDS)
    sv = parallel.ShardedVariable(
        de.Variable(name="spill_sharded", dim=DIM, init_capacity=C,
                    evict_strategy=de.EvictStrategy.LRU), mesh)
    opt = de.Adagrad(0.1)
    hy = HybridTable(sv, SPILL_HIGH, SPILL_LOW)
    hy.state = sv.create_slots(hy.state, opt)
    cuda_ops.reset_launches()
    prefill = _spill_prefill(torch, sv.var, hy, keys, seed, dev)
    rng = np.random.default_rng(seed + 7)
    perm = rng.permutation(len(keys))
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    steps = []
    for i in range(SPILL_SHARDED_STEPS):
        ids = _zipf_ids(rng, keys, perm, SPILL_BATCH)
        g = torch.randn((SPILL_BATCH, DIM), device=dev, generator=gen)
        steps.append(_spill_step(torch, de, sv.var, hy, opt, ids, g, i + 1,
                                 dev))
    launches = _launched(cuda_ops, "(f) sharded",
                         ("row_gather", "row_scatter",
                          "fused_update_scatter"), "spill")
    out = {"shards": SHARDS, "prefill": prefill, "steps": steps,
           "ms_per_step_median": float(np.median([s["ms"] for s in steps])),
           "live_keys_per_shard": [int(hashtable.size(sv.spec, st))
                                   for st in hy.state.shards],
           "total_keys_after": hy.tier.total_keys(hy.state),
           "launches": launches}
    del hy
    torch.cuda.empty_cache()
    return out


def _spill_remote(torch, cuda_ops, de, dev, seed):
    """(f2) A SpillTier whose store is a RemoteKVStore on an in-process
    HostKVServer over the native store, beside one over a local native
    store, from copies of one table (dim 64, SPILL_REMOTE_CAP slots,
    Adagrad, three quarters full): SPILL_REMOTE_N rows demoted, then
    promoted back; planes, stores and stats bit-equal after each; ms per
    row each way."""
    from recommenders_addons_tpu_torch.ops.spill import (
        SpillTier,
        make_host_store,
    )
    from recommenders_addons_tpu_torch.serving.kv import (
        HostKVServer,
        RemoteKVStore,
    )

    var = de.Variable(name="spill_remote", dim=DIM,
                      init_capacity=SPILL_REMOTE_CAP,
                      evict_strategy=de.EvictStrategy.LRU)
    st = de.create_slots(var, var.init(), de.Adagrad(0.1))
    n_fill = SPILL_REMOTE_CAP * 3 // 4
    k = torch.from_numpy(_spill_keys(seed + 9, n_fill)).to(dev)
    scores = torch.randint(0, 1000, (n_fill,), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed + 9), dtype=torch.int32)
    st = var.import_batch(st, k, _spill_values(torch, k, DIM, seed),
                          scores=scores)
    states = {"remote": st, "local": _clone_state(st)}
    del st
    cuda_ops.reset_launches()
    ms = {}
    with HostKVServer(make_host_store(DIM), port=0) as srv:
        tiers = {"remote": SpillTier(var, store=RemoteKVStore(
                     srv.host, srv.port, dim=DIM)),
                 "local": SpillTier(var)}

        def run(what, fn):
            for name, tier in tiers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[name] = fn(tier, states[name])
                torch.cuda.synchronize()
                ms[f"{name}_{what}_ms"] = (time.perf_counter() - t0) * 1e3
            a, b = states["remote"], states["local"]
            n = a.capacity * a.chunks  # the trash row after is unspecified
            for f in ("key_lo", "key_hi", "scores", "rows"):
                if not torch.equal(getattr(a, f)[:n], getattr(b, f)[:n]):
                    raise AssertionError(f"spill (f) remote {what}: {f} "
                                         "differ")
            _same_store(_store_sorted(tiers["remote"].store),
                        _store_sorted(tiers["local"].store),
                        f"spill (f) remote {what}")
            if vars(tiers["remote"].stats) != vars(tiers["local"].stats):
                raise AssertionError(f"spill (f) remote {what}: stats "
                                     "differ")

        run("demote", lambda t, st: t.demote(st, SPILL_REMOTE_N))
        ids = tiers["local"].store.export_all()[0]
        run("promote", lambda t, st: t.promote(st, ids))
        promoted = tiers["remote"].stats.promoted
    launches = _launched(cuda_ops, "(f) remote", ("row_gather",
                                                  "row_scatter"), "spill")
    n = SPILL_REMOTE_N
    out = dict(ms, rows=n, promoted=promoted,
               **{f"{k[:-3]}_us_per_row": v * 1e3 / n
                  for k, v in ms.items()}, launches=launches)
    del states
    torch.cuda.empty_cache()
    return out


def spill_phase(torch, cuda_ops, dev, seed):
    """Phase 9: the spill tier at DLRM's table width (dim 64, C slots,
    Adagrad created first, LRU, f32) under a HybridTable (watermarks
    SPILL_HIGH / SPILL_LOW) with SPILL_KEYS keys, twice its capacity:
    (a) the prefill, (b) training through the tier, (c) a narrow run
    card against CPU, (d) both tiers checkpointed and cold-restored, (e)
    tiered serving, (f) a ShardedSpillTier and a networked shared store.
    Launch counts are reset before each part and read after it."""
    import shutil

    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.ops.spill import HybridTable

    t_phase = time.perf_counter()
    var = de.Variable(name="spill", dim=DIM, init_capacity=C,
                      evict_strategy=de.EvictStrategy.LRU)
    opt = de.Adagrad(0.1)
    hy = HybridTable(var, SPILL_HIGH, SPILL_LOW)
    hy.state = de.create_slots(var, hy.state, opt)
    keys = _spill_keys(seed, SPILL_KEYS)
    cuda_ops.reset_launches()
    prefill = _spill_prefill(torch, var, hy, keys, seed, dev)
    prefill["launches"] = _launched(cuda_ops, "(a)", ("row_gather",
                                                      "row_scatter"), "spill")
    training = _spill_training(torch, cuda_ops, de, var, hy, opt, keys,
                               seed, dev)
    narrow = _spill_narrow(torch, de, dev, seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        ckpt = _spill_checkpoint(torch, cuda_ops, de, var, hy, opt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    serving = _spill_serving(torch, cuda_ops, de, var, hy, keys, seed, dev)
    del hy
    torch.cuda.empty_cache()
    sharded = _spill_sharded(torch, cuda_ops, de, dev, keys, seed)
    remote = _spill_remote(torch, cuda_ops, de, dev, seed)
    return {"config": f"Variable(dim={DIM}, init_capacity={C >> 20}Mi, "
                      "LRU, float32) + Adagrad accumulator (rows of 512 B), "
                      f"HybridTable({SPILL_HIGH}, {SPILL_LOW}); "
                      f"{SPILL_KEYS >> 20}Mi keys",
            "prefill": prefill, "training": training, "card_vs_cpu": narrow,
            "checkpoint": ckpt, "serving": serving, "sharded": sharded,
            "remote": remote, "phase_s": time.perf_counter() - t_phase,
            "launches": {"spill_prefill": prefill["launches"],
                         "spill_training": training["launches"],
                         "spill_checkpoint": ckpt["launches"],
                         "spill_serving": serving["launches"],
                         "spill_sharded": sharded["launches"],
                         "spill_remote": remote["launches"]}}


def _dma_inputs(torch, dev, gen, cap, ch, n):
    """A [cap*ch, 128] table of random words; gather indices (random
    rows) and scatter indices (unique rows), each with sentinels,
    negatives and past-the-end indices mixed in; random words for the
    scattered rows."""
    words = (-(1 << 31), (1 << 31) - 1)
    table = torch.randint(*words, (cap * ch, LANES), dtype=torch.int32,
                          device=dev, generator=gen).view(torch.float32)
    idx = torch.randint(0, cap, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    sidx = torch.randperm(cap, device=dev, generator=gen)[:n].to(torch.int32)
    for i in (idx, sidx):
        i[::97], i[3::101], i[5::103] = cap, -1, cap + 9
    rows = torch.randint(*words, (n * ch, LANES), dtype=torch.int32,
                         device=dev, generator=gen).view(torch.float32)
    return table, idx, sidx, rows


def dma_bench_phase(torch, cuda_ops, dev, gen, card):
    """Phase 10: the row-copy micro-benchmark (tools/dma_bench.py) at its
    two full-width shapes: every variant of its lists, plus a predicated
    gather (row and premultiplied predicate) and a predicated scatter,
    held bit-exact against its plain version at a ragged N; then the
    tool's main() at both shapes, the path whose launches are counted;
    then each of its four kernels timed beside its plain version."""
    from recommenders_addons_tpu_torch.tools import dma_bench

    pred = dict(nbuf=8, predicated=True, bitand=False, unroll=4)
    gathers = [kw for _, kw in dma_bench.VARIANTS] + [
        dict(pred, premul=False), dict(pred, premul=True)]
    scatters = [kw for _, kw in dma_bench.SC_VARIANTS] + [
        dict(nbuf=8, predicated=True, unroll=4, extra_rows=1, premul=False)]
    errs = {k.name: 0 for k in (cuda_ops.DMA_GATHER,
                                cuda_ops.DMA_GATHER_GROUPED,
                                cuda_ops.DMA_SCATTER_GROUPED,
                                cuda_ops.DMA_SCATTER)}
    checked = {}
    for log2cap, ch in DMA_SHAPES:
        cap = 1 << log2cap
        table, idx, sidx, rows = _dma_inputs(torch, dev, gen, cap, ch,
                                             DMA_N_CHECK)
        for kw in gathers:
            fn = dma_bench.make_variant(kw, ch=ch, scatter=False)
            e = _same_bits(torch, fn(table, idx), fn.plain(table, idx))
            errs[fn.kernel.name] = max(errs[fn.kernel.name], e)
        trash = torch.cat([table, table.new_zeros((ch, LANES))])
        del table
        for kw in scatters:
            fn = dma_bench.make_variant(kw, ch=ch, scatter=True)
            a = trash.clone()
            fn(a, sidx, rows)
            b = trash.clone()
            fn.plain(b, sidx, rows)
            e = _same_bits(torch, a[:cap * ch], b[:cap * ch])
            errs[fn.kernel.name] = max(errs[fn.kernel.name], e)
            del a, b
        del trash, idx, sidx, rows
        torch.cuda.empty_cache()
        checked[f"cap={cap} ch={ch}"] = len(gathers) + len(scatters)
    # the pipelines' turns (gathers only): rows of 128 KiB, one a stage,
    # on a table of 64 rows; and N = 2^18 + 3, where every block wraps
    # its ring of stages many times. Their own generator leaves the later
    # phases' inputs as they were.
    pipe_gen = torch.Generator(device=dev).manual_seed(gen.initial_seed() + 1)
    for rows, ch, n in DMA_PIPE_CHECKS:
        table, idx, _, _ = _dma_inputs(torch, dev, pipe_gen, rows, ch, n)
        idx[2::17] = (1 << 31) - 5  # premultiplied, these wrap int32
        for kw in gathers:
            if kw.get("grouped") and kw["group"] * ch * 512 >= 1 << 20:
                kw = dict(kw, group=(1 << 19) // (ch * 512))  # 4 rows
            fn = dma_bench.make_variant(kw, ch=ch, scatter=False)
            e = _same_bits(torch, fn(table, idx), fn.plain(table, idx))
            errs[fn.kernel.name] = max(errs[fn.kernel.name], e)
        del table, idx
        torch.cuda.empty_cache()
        checked[f"rows={rows} ch={ch} N={n}"] = len(gathers)
    bad = [k for k, e in errs.items() if e]
    if bad:
        raise AssertionError(f"dma_bench kernels disagree with their plain "
                             f"versions: {bad}")

    # -- the main path: counters from 0, the tool at both shapes ---------
    cuda_ops.reset_launches()
    runs = {}
    for log2cap, ch in DMA_SHAPES:
        runs[f"cap={1 << log2cap} ch={ch}"] = dma_bench.main(
            [str(log2cap), str(ch)], device=dev)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_ops.KERNELS}
    missing = [k for k in errs if not launches[k]]
    if missing:
        raise AssertionError(f"not launched on the dma_bench path: "
                             f"{missing} ({launches})")
    for run in runs.values():
        for e in [*run["gather"].values(), *run["scatter"].values()]:
            if not (math.isfinite(e["ns_per_row"]) and e["ms"] > 0):
                raise AssertionError(f"dma_bench timing not finite: {e}")

    # -- each kernel beside its plain version at the tool's default shape
    log2cap, ch = DMA_SHAPES[0]
    cap = 1 << log2cap
    main_run = runs[f"cap={cap} ch={ch}"]
    table, idx, sidx, rows = _dma_inputs(torch, dev, gen, cap, ch,
                                         dma_bench.BATCHES[1])
    trash = torch.cat([table, table.new_zeros((ch, LANES))])
    sidx = torch.where((sidx >= 0) & (sidx <= cap), sidx, cap)
    results = []
    for name, (variant, kw), scatter, replaces, fn_name, lib in (
            ("dma_gather", dma_bench.VARIANTS[0], False, 32,
             "make_gather (pallas_call :96)", "torch.index_select"),
            ("dma_gather_grouped", dma_bench.VARIANTS[2], False, 114,
             "make_gather_grouped (pallas_call :164)", "torch.index_select"),
            ("dma_scatter_grouped", dma_bench.SC_VARIANTS[2], True, 182,
             "make_scatter_grouped (pallas_call :228)",
             "torch.Tensor.index_copy_"),
            ("dma_scatter", dma_bench.SC_VARIANTS[0], True, 251,
             "make_scatter (pallas_call :314)", "torch.Tensor.index_copy_")):
        fn = dma_bench.make_variant(kw, ch=ch, scatter=scatter)
        if scatter:
            plain_ms = _time_ms(torch, lambda: fn.plain(trash, sidx, rows), 10)
        else:
            plain_ms = _time_ms(torch, lambda: fn.plain(table, idx), 10)
        e = main_run["scatter" if scatter else "gather"][variant]
        results.append({
            "name": name, "route": "cuda",
            "source": f"recommenders_addons_tpu_torch/csrc/{name}.cu",
            "replaces": f"tools/dma_bench.py:{replaces}",
            "replaces_fn": fn_name, "variant": variant,
            "max_abs_err": errs[name], "match": errs[name] == 0,
            "ms": e["ms"], "kernel_ms": e["ms"], "ns_per_row": e["ns_per_row"],
            "plain_ms": plain_ms,
            "library_ms": main_run["scatter" if scatter else "gather"][
                lib]["ms"],
            "library_call": lib, "bound_ms": e["bound_ms"],
            "bound_by": "bytes", "bytes": e["bytes"],
            "shape": f"CAP={cap} ch={ch} N={dma_bench.BATCHES[1]}",
        })
        if not scatter:  # the gathers redesigned as pipelines
            busy, top = _device_profile(torch, lambda: fn(table, idx))
            results[-1].update(x_bound=e["ms"] / e["bound_ms"],
                               x_library=e["ms"] / results[-1]["library_ms"],
                               trace={"busy": busy, "top_ms": top})
    del table, trash, idx, sidx, rows
    torch.cuda.empty_cache()
    summary = {"card": card, "checked_variants": checked,
               "check_n": DMA_N_CHECK, "bit_exact": True,
               "launches": launches, "runs": runs}
    return results, summary


def _ab_fused_check(torch, fn, mode, table, want, idx, packed, g):
    """``fn`` on a copy of ``table`` against ``want`` (its plain version's
    result): identity and rawcopy rows bit-exact; Adam's NaN positions
    equal, its other updated words within 4 ulps, its pad columns +0.0;
    every row it must not write bit-exact. Returns (ulps or max |word
    difference|, max |difference| of the updated floats)."""
    from recommenders_addons_tpu_torch.tools.fused_sweep import max_ulps

    a = table.clone()
    fn(a, idx, packed, g, AB_STEP)
    torch.cuda.synchronize()
    w = packed.shape[1]
    rows = idx.long()
    ra, rb = a.view(-1, w), want.view(-1, w)
    wa, wb = ra[rows], rb[rows]
    if mode == "adam":
        nan_a, nan_b = torch.isnan(wa), torch.isnan(wb)
        if not torch.equal(nan_a, nan_b):
            raise AssertionError("ab_fused adam: NaN positions differ")
        keep = ~nan_a[:, :192]
        va, vb = wa[:, :192][keep], wb[:, :192][keep]
        ulps = max_ulps(va, vb, 32)
        err = float((va - vb).abs().max())
        if ulps > 4:
            raise AssertionError(f"ab_fused adam: {ulps} ulps off its plain "
                                 f"version")
        if bool(wa[:, 192:].view(torch.int32).any()):
            raise AssertionError("ab_fused adam: pad columns not +0.0")
    else:
        ulps = err = _same_bits(torch, wa, wb)
        if ulps:
            raise AssertionError(f"ab_fused {mode}: rows differ")
    ra[rows] = rb[rows]  # the written rows agree: the rest must be untouched
    if not torch.equal(a.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"ab_fused {mode}: rows it must not write "
                             f"differ")
    del a
    return ulps, err


def ab_tools_phase(torch, cuda_ops, dev, gen, rate, card):
    """Phase 11: the fused-apply probe's kernel (ab_fused) against its
    plain version at the probe's full width, every mode and knob; the
    radix-histogram probe's kernel (radix_hist) against torch.bincount;
    each timed beside its plain version; then both tools' main(), the
    paths whose launches are counted."""
    from recommenders_addons_tpu_torch.ops import hashing
    from recommenders_addons_tpu_torch.tools import ab_kernel_cost as akc
    from recommenders_addons_tpu_torch.tools import ab_radix_plan as arp
    from recommenders_addons_tpu_torch.tools import hist_bench

    # -- ab_fused: 2Mi rows of 1 KiB, unique indices, v >= 0 -------------
    cap, w, n = akc.CAP, akc.W, AB_N_CHECK
    table = torch.rand(((cap + 1) * akc.CH, LANES), device=dev,
                       generator=gen)
    idx = torch.randperm(cap, device=dev, generator=gen)[:n].to(torch.int32)
    packed = torch.rand((n, w), device=dev, generator=gen) * 0.95 + 0.05
    g = torch.randn((n, akc.D), device=dev, generator=gen) * 0.01
    checks = {}
    for mode in akc.MODES:
        want = table.clone()
        akc.make_fused(mode).plain(want, idx, packed, g, AB_STEP)
        for sub in akc.SUBS:
            for nbuf in akc.NBUFS:
                checks[f"{mode} sub={sub} nbuf={nbuf}"] = _ab_fused_check(
                    torch, akc.make_fused(mode, sub=sub, nbuf=nbuf), mode,
                    table, want, idx, packed, g)
        del want
    # the probe's own inputs: standard normal, so v < 0 gives NaNs
    t_nan = torch.randn(table.shape, device=dev, generator=gen)
    p_nan = torch.randn((n, w), device=dev, generator=gen)
    g_nan = torch.randn((n, akc.D), device=dev, generator=gen) * 0.01
    fn = akc.make_fused("adam", sub=128)
    want = t_nan.clone()
    fn.plain(want, idx, p_nan, g_nan, AB_STEP)
    nan_words = int(torch.isnan(want.view(-1, w)[idx.long()]).sum())
    checks["adam sub=128 nbuf=32, standard normal"] = _ab_fused_check(
        torch, fn, "adam", t_nan, want, idx, p_nan, g_nan)
    del t_nan, p_nan, g_nan, want
    torch.cuda.empty_cache()
    if not nan_words:
        raise AssertionError("the standard-normal check made no NaN")

    # timed at the probe's larger batch: adam chunk128, its first variant
    nt = akc.BATCHES[1]
    i_t, p_t, g_t = idx[:nt], packed[:nt], g[:nt]
    f_ms = _time_ms(torch, lambda: fn(table, i_t, p_t, g_t, AB_STEP), 50)
    f_plain = _time_ms(torch, lambda: fn.plain(table, i_t, p_t, g_t,
                                               AB_STEP), 10)
    f_bytes = nt * akc.row_bytes("adam")  # unique rows: each written once
    f_ops = nt * akc.D * _ADAM_FLOPS
    del table, idx, packed, g, i_t, p_t, g_t
    torch.cuda.empty_cache()

    # -- radix_hist: bucket ids of the 2Mi table, and ragged odd ids -----
    nb = 1 << 15  # Variable(dim=64, init_capacity=2Mi): 64-slot buckets
    keys = torch.randint(1, 1 << 62, (nt,), device=dev, generator=gen)
    bids = hashing.bucket_of(keys, nb)
    odd = torch.randint(-5000, 50000, (70001,), dtype=torch.int32,
                        device=dev, generator=gen)
    big = hashing.bucket_of(torch.randint(1, 1 << 62, (HIST_N_BIG,),
                                          device=dev, generator=gen), nb)
    h_err = 0
    for b in (bids, odd, odd[1:], big):  # odd[1:]: off a 16-byte boundary
        got = arp.pallas_hist(b, nb)
        lib = torch.bincount((b & 1023).long(), minlength=1024)
        h_err = max(h_err, _same_bits(torch, got, arp.radix_hist_plain(b)),
                    _same_bits(torch, got, lib.to(torch.int32)))
    if h_err:
        raise AssertionError("radix_hist disagrees with torch.bincount")
    del big
    # its times against the launch floor (an empty kernel) at 8,192,
    # 65,536 and 4,194,304 ids, and its device operations per call
    hist_times = hist_bench.main([])
    one_op = {"kernels": 1, "memsets": 0, "others": 0}
    ops = hist_times["graph_ops_per_call"]["radix_hist"]
    if any(v != one_op for v in ops.values()):
        raise AssertionError(f"radix_hist is not one device operation a "
                             f"call: {ops}")
    low = (bids & 1023).long()
    h_ms = _time_ms(torch, lambda: arp.pallas_hist(bids, nb), 100)
    h_plain = _time_ms(torch, lambda: arp.radix_hist_plain(bids), 20)
    h_lib = _time_ms(torch, lambda: torch.bincount(low, minlength=1024), 20)
    h_bytes = nt * 4 + 1024 * 4
    del keys, odd, low

    # -- the main paths: counters from 0, each tool's main() -------------
    launches, runs = {}, {}
    for path, run in (("ab_kernel_cost", akc.main),
                      ("ab_radix_plan", lambda: arp.main([]))):
        cuda_ops.reset_launches()
        runs[path] = run()
        torch.cuda.synchronize()
        launches[path] = {k.name: k.launches for k in cuda_ops.KERNELS}
        torch.cuda.empty_cache()
    for path, k in (("ab_kernel_cost", "ab_fused"),
                    ("ab_radix_plan", "radix_hist")):
        if not launches[path][k]:
            raise AssertionError(f"{k} not launched on the {path} path: "
                                 f"{launches[path]}")
    nums = [e["ns_per_row"] for e in runs["ab_kernel_cost"][
        "variants"].values()] + list(runs["ab_radix_plan"][
            "ns_per_key"].values())
    if len(nums) != 9 or not all(math.isfinite(x) for x in nums):
        raise AssertionError(f"a probe variant gave no finite number: "
                             f"{runs}")

    def bound(nbytes, ops):
        s_bytes, s_ops = nbytes / rate, ops / _F32_FLOPS
        return max(s_bytes, s_ops) * 1e3, (
            "bytes" if s_bytes >= s_ops else "operations")

    f_bound, f_by = bound(f_bytes, f_ops)
    h_bound, h_by = bound(h_bytes, nt)
    results = [{
        "name": "ab_fused", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/ab_fused.cu",
        "replaces": "tools/ab_kernel_cost.py:56",
        "replaces_fn": "make_fused (pallas_call :122)",
        "variant": "adam chunk128 (sub=128, nbuf=32)",
        "max_abs_err": max(e for _, e in checks.values()),
        "max_ulps": {k: u for k, (u, _) in checks.items()},
        "nan_words_checked": nan_words, "match": True,
        "ms": f_ms, "kernel_ms": f_ms, "plain_ms": f_plain,
        "library_ms": None,
        "library_call": "none (no single PyTorch call fuses a row-wise "
                        "optimizer with an indexed store)",
        "bound_ms": f_bound, "bound_by": f_by, "bytes": f_bytes,
        "ops": f_ops,
        "shape": f"CAP={cap} ch={akc.CH} W={w} D={akc.D} N={nt}",
    }, {
        "name": "radix_hist", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/radix_hist.cu",
        "replaces": "tools/ab_radix_plan.py:140",
        "replaces_fn": "pallas_hist / _hist_kernel (kernel :114, "
                       "pallas_call :144)",
        "max_abs_err": h_err, "match": True,
        "ms": h_ms, "kernel_ms": h_ms, "plain_ms": h_plain,
        "library_ms": h_lib,
        "library_call": "torch.bincount (on the masked ids)",
        "bound_ms": h_bound, "bound_by": h_by, "bytes": h_bytes, "ops": nt,
        "shape": f"N={nt} bucket ids of {nb} buckets, 1024 bins",
        "ms_by_n": hist_times["ms"]["radix_hist"],
        "bound_ms_by_n": hist_times["bound_ms"],
        "launch_floor_ms": hist_times["launch_floor_ms"],
        "device_ops_per_call": 1,
        "graph_ops_by_n": ops,
        "profiled_ops_per_call": hist_times["profiled_ops_per_call"][
            "radix_hist"],
    }]
    summary = {"card": card, "fused_check_n": n,
               "fused_checks": {k: {"ulps_or_bits": u, "max_abs_err": e}
                                for k, (u, e) in checks.items()},
               "hist_check_n": [nt, 70001, 70000, HIST_N_BIG],
               "hist_bench": hist_times, "launches": launches,
               "runs": runs}
    return results, summary


# ---------------------------------------------------------------------------
# 12. the 64-bit and bool value dtypes
# ---------------------------------------------------------------------------


def _wide_bits(torch, t):
    """A tensor's bits as a comparable tensor: 64-bit values as int64,
    bool as itself."""
    return t.view(torch.int64) if t.element_size() == 8 else t


def _wide_values(torch, dt, n, dim, gen, dev):
    """``[n, dim]`` random values of ``dt`` on ``dev``: float normals,
    int64 words over most of the range, bools."""
    if dt.is_floating_point:
        return torch.randn((n, dim), dtype=dt, device=dev, generator=gen)
    if dt == torch.int64:
        return torch.randint(-(1 << 62), 1 << 62, (n, dim), dtype=dt,
                             device=dev, generator=gen)
    return torch.randint(0, 2, (n, dim), device=dev, generator=gen).bool()


def _wide_per_key(torch, var, st):
    """Live keys sorted, with their scores and used columns (value and
    slot rows) as bits."""
    from recommenders_addons_tpu_torch.ops import hashtable

    idx = torch.nonzero(hashtable.occupancy_mask(var.spec, st)).reshape(-1)
    keys, order = torch.sort(st.keys[idx])
    w = st.dim * (1 + len(st.slot_names))
    rows = st.rows_logical[idx, :w][order].contiguous()
    return {"keys": keys, "scores": st.scores[idx][order],
            "rows": _wide_bits(torch, rows)}


def _dtypes_fill(torch, cuda_ops, de, dev, gen, seed):
    """(a) The three tables (and the f32 table of (c)) filled with
    DT_KEYS keys in blocks of DT_BLOCK; (b) every key and DT_BLOCK
    misses looked up, each row bit-equal to the values put."""
    rng = np.random.default_rng(seed + 12)
    keys_np = rng.choice(1 << 40, size=DT_KEYS + DT_BLOCK, replace=False)
    keys = torch.from_numpy(keys_np.astype(np.int64)).to(dev)
    misses, keys = keys[DT_KEYS:], keys[:DT_KEYS]
    tables, out = {}, {}
    for name, dt in (("float64", torch.float64), ("int64", torch.int64),
                     ("bool", torch.bool), ("float32", torch.float32)):
        init = (de.initializers.normal(0.05) if dt.is_floating_point
                else None)
        var = de.Variable(name=f"dtypes_{name}", dim=DT_DIM,
                          init_capacity=DT_CAP, value_dtype=dt,
                          initializer=init, device=dev)
        st = var.init()
        if dt.is_floating_point:  # the table step's rows: value, m, v
            st = de.create_slots(var, st, de.Adam(0.001))
        vals = _wide_values(torch, dt, DT_KEYS, DT_DIM, gen, dev)
        cuda_ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for off in range(0, DT_KEYS, DT_BLOCK):
            st = var.upsert(st, keys[off:off + DT_BLOCK],
                            vals[off:off + DT_BLOCK])
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        fill_launches = {k.name: k.launches for k in cuda_ops.KERNELS}
        size = int(var.size(st))
        if size != DT_KEYS:
            raise AssertionError(f"dtypes {name}: {size} keys after the "
                                 f"fill, not {DT_KEYS}")
        # (b) every key, then the misses: hits equal the values put,
        # misses the default row (zeros), bit for bit
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        found_all = True
        for off in range(0, DT_KEYS, DT_BLOCK):
            got, found = var.lookup(st, keys[off:off + DT_BLOCK],
                                    return_exists=True)
            found_all &= bool(found.all())
            if not torch.equal(_wide_bits(torch, got),
                               _wide_bits(torch, vals[off:off + DT_BLOCK])):
                raise AssertionError(f"dtypes {name}: looked-up rows at "
                                     f"{off} differ from the values put")
        got, found = var.lookup(st, misses, return_exists=True)
        torch.cuda.synchronize()
        lookup_ms = (time.perf_counter() - t0) * 1e3
        if not found_all or bool(found.any()) or bool(got.to(
                torch.float32).any()):
            raise AssertionError(f"dtypes {name}: found flags or the "
                                 f"default rows are wrong")
        lookup_launches = {k.name: k.launches for k in cuda_ops.KERNELS}
        # 64-bit rows go through the row kernels, bool rows by indexing
        kernel_rows = st.rows.element_size() != 1
        for part, n, kname in (("fill", fill_launches, "row_scatter"),
                               ("lookup", lookup_launches, "row_gather")):
            if bool(n[kname]) != kernel_rows:
                raise AssertionError(f"dtypes {name} {part}: {kname} "
                                     f"launched {n[kname]} times")
        tables[name] = (var, st)
        del vals
        out[name] = {"row_bytes": st.chunks * LANES * st.rows.element_size(),
                     "table_gb": st.rows.numel() * st.rows.element_size()
                     / 1e9,
                     "fill_ms": fill_ms, "lookup_ms": lookup_ms,
                     "launches_fill": fill_launches,
                     "launches_lookup": lookup_launches}
    return tables, keys, out


def _dtypes_train(torch, cuda_ops, de, tables, keys, dev, gen, seed):
    """(c) DT_STEPS Adam steps of DT_BLOCK zipf(1.2) ids (one tenth new
    keys) on the f64 table and on the f32 one; the f64 step's own row
    gathers and scatters recorded for (f)."""
    from recommenders_addons_tpu_torch.tools import fused_sweep as fs

    rng = np.random.default_rng(seed + 13)
    perm = torch.from_numpy(rng.permutation(DT_KEYS)).to(dev)
    batches = []
    for t in range(DT_STEPS):
        z = torch.from_numpy((rng.zipf(1.2, DT_BLOCK) - 1) % DT_KEYS).to(dev)
        ids = keys[perm[z]]
        fresh = torch.from_numpy(rng.integers(
            1 << 41, 1 << 42, DT_BLOCK // 10)).to(dev)
        ids[: DT_BLOCK // 10] = fresh
        g = torch.randn((DT_BLOCK, DT_DIM), dtype=torch.float64,
                        device=dev, generator=gen)
        batches.append((ids, g))
    opt = de.Adam(0.001)
    out, own = {}, {}
    for name in ("float64", "float32"):
        var, st = tables[name]
        cuda_ops.reset_launches()
        times = []
        for t, (ids, g) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()

            def one_step(st=st, ids=ids, g=g, t=t):
                emb, ctx = var.embedding_lookup(st, ids, step=t + 1)
                return var.apply_gradients(st, ctx, g.to(emb.dtype), opt,
                                           step=t)

            if name == "float64" and t == DT_STEPS - 1:
                # (f): the last step's own operands of kernels 1 and 2
                res = []
                own["gather"] = fs.record_calls(
                    lambda: own.__setitem__("scatter", fs.record_calls(
                        lambda: res.append(one_step()),
                        "scatter_rows_set_2d", limit=1)),
                    "gather_rows_2d", limit=1)
                st = res[0]
            else:
                st = one_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = _launched(cuda_ops, name, (
            ("row_gather", "row_scatter") if name == "float64"
            else ("row_gather", "fused_update_scatter")), "dtypes train")
        if name == "float64" and launches["fused_update_scatter"]:
            raise AssertionError("an f64 apply launched the fused kernel")
        vals = st.rows_logical[:, :DT_DIM]
        if not bool(torch.isfinite(vals).all()):
            raise AssertionError(f"dtypes train {name}: rows not finite")
        tables[name] = (var, st)
        out[name] = {"ms_per_step": times, "median_ms": float(
            np.median(times[1:])), "launches": launches,
            "size": int(var.size(st))}
    out["f64_over_f32"] = (out["float64"]["median_ms"]
                           / out["float32"]["median_ms"])
    return out, own


def _dtypes_narrow(torch, de, dev, seed):
    """(d) A DT_NARROW_CAP-slot f64 table (dim DT_DIM, Adam, normal
    initial rows) trains DT_NARROW_STEPS steps on the card and on the
    CPU: key planes and scores bit-exact, rows within DT_NARROW_RTOL."""
    rng = np.random.default_rng(seed + 14)
    batches = [(rng.integers(1, 40_000, DT_NARROW_BATCH).astype(np.int64),
                rng.standard_normal((DT_NARROW_BATCH, DT_DIM)))
               for _ in range(DT_NARROW_STEPS)]
    runs = {}
    for where in ("cpu", dev):
        var = de.Variable(name="dtypes_narrow", dim=DT_DIM,
                          init_capacity=DT_NARROW_CAP,
                          value_dtype=torch.float64,
                          initializer=de.initializers.normal(0.05),
                          device=where)
        opt = de.Adam(0.01)
        st = de.create_slots(var, var.init(), opt)
        for t, (ids, g) in enumerate(batches):
            emb, ctx = var.embedding_lookup(
                st, torch.from_numpy(ids).to(where), step=t + 1)
            st = var.apply_gradients(st, ctx, torch.from_numpy(g).to(where),
                                     opt, step=t)
        runs[str(where)] = st
    c, g = runs["cpu"], runs[str(dev)]
    for f in ("key_lo", "key_hi", "scores"):
        if not torch.equal(getattr(g, f).cpu(), getattr(c, f)):
            raise AssertionError(f"dtypes narrow {f}: card and CPU differ")
    got, want = g.rows_logical.cpu(), c.rows_logical
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=DT_NARROW_RTOL, atol=0):
        raise AssertionError(f"dtypes narrow rows differ by {err}")
    return {"cap": DT_NARROW_CAP, "steps": DT_NARROW_STEPS,
            "batch": DT_NARROW_BATCH, "rows_max_abs_err": err,
            "rows_bit_equal": bool(torch.equal(_wide_bits(torch, got),
                                               _wide_bits(torch, want))),
            "rtol": DT_NARROW_RTOL}


def _dtypes_checkpoint(torch, cuda_ops, tables, tmp):
    """(e) Each table saved from the card and from a CPU copy (files
    byte-identical) and restored on the card (per key bit-equal)."""
    import dataclasses as dc
    import filecmp
    import os

    from recommenders_addons_tpu_torch.ops import hashtable
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt_lib

    out = {}
    cuda_ops.reset_launches()
    for name in ("float64", "int64", "bool"):
        var, st = tables[name]
        card_dir = os.path.join(tmp, name, "card")
        vdir, save_ms = _timed(torch, lambda: ckpt_lib.save_dynamic_embedding(
            var, st, card_dir))
        cpu_var = dc.replace(var, device="cpu")
        cpu_st = hashtable.TableState(
            key_lo=st.key_lo.cpu(), key_hi=st.key_hi.cpu(),
            rows=st.rows.cpu(), scores=st.scores.cpu(), dim=st.dim,
            slot_names=st.slot_names, slot_inits=st.slot_inits,
            key_dtype_name=st.key_dtype_name,
            value_dtype_name=st.value_dtype_name)
        cpu_vdir = ckpt_lib.save_dynamic_embedding(
            cpu_var, cpu_st, os.path.join(tmp, name, "cpu"))
        del cpu_st
        files = sorted(f for f in os.listdir(vdir) if not f.endswith(".json"))
        if files != sorted(f for f in os.listdir(cpu_vdir)
                           if not f.endswith(".json")):
            raise AssertionError(f"dtypes {name}: card and CPU wrote "
                                 f"different files")
        for f in files:
            if not filecmp.cmp(os.path.join(vdir, f),
                               os.path.join(cpu_vdir, f), shallow=False):
                raise AssertionError(f"dtypes {name}: {f} differs, card "
                                     f"against CPU")
        fresh = var.init()
        if st.slot_names:
            for nm in st.slot_names:
                fresh = hashtable.with_slot(fresh, nm, st.slot_init(nm))
        restored, restore_ms = _timed(
            torch, lambda: ckpt_lib.load_dynamic_embedding(var, fresh,
                                                           card_dir))
        a, b = _wide_per_key(torch, var, st), _wide_per_key(torch, var,
                                                            restored)
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"dtypes {name}: restored {k} differ "
                                     f"key by key")
        out[name] = {"keys": int(a["keys"].numel()), "save_ms": save_ms,
                     "restore_ms": restore_ms,
                     "gb": _dir_bytes(card_dir) / 1e9, "files": len(files)}
        del restored, fresh
    out["launches"] = _launched(cuda_ops, "checkpoint",
                                ("row_gather", "row_scatter"), "dtypes")
    return out


def _dtypes_own_calls(torch, cuda_ops, own, rate):
    """(f) Kernels 1 and 2 on an f64 step's own operands (2 KiB rows, the
    64-bit view doubling ch) against their plain versions, bit-exact,
    and timed beside them, the library call and the bytes bound."""
    from recommenders_addons_tpu_torch.tools import row_sweep

    res = {}
    for kind in ("gather", "scatter"):
        if not own.get(kind):
            raise AssertionError(f"the f64 step made no row {kind}")
        a = own[kind][0]
        table, ch = a["table2d"], a["ch"]
        idx = a["idx"].reshape(-1).to(torch.int32)
        n = idx.numel()
        row_b = ch * LANES * table.element_size()
        rows = table.view(-1, ch * LANES)
        nrows = rows.shape[0]
        valid = (idx >= 0) & (idx < nrows if kind == "gather"
                              else idx < a["cap"])
        if kind == "gather":
            vc = a["vc"] or ch
            fn = lambda: cuda_ops.gather_rows_2d(**a)  # noqa: E731
            plain = lambda: cuda_ops.gather_rows_2d_plain(**a)  # noqa: E731
            err = int((_wide_bits(torch, fn())
                       != _wide_bits(torch, plain())).sum())
            safe = idx.clamp(0, nrows - 1).long()
            lib = lambda: torch.index_select(rows, 0, safe)  # noqa: E731
            read = int(torch.unique(safe).numel())
            nbytes = n * 4 + (read + n) * vc * LANES * table.element_size()
        else:
            got = table.clone()
            cuda_ops.scatter_rows_set_2d(**dict(a, table2d=got))
            want = table.clone()
            cuda_ops.scatter_rows_set_2d_plain(**dict(a, table2d=want))
            cap_rows = a["cap"] * ch
            err = int((_wide_bits(torch, got[:cap_rows])
                       != _wide_bits(torch, want[:cap_rows])).sum())
            del got, want
            src = a["rows"].reshape(n, -1)
            safe = torch.where(valid, idx, a["cap"]).long()
            fn = lambda: cuda_ops.scatter_rows_set_2d(**a)  # noqa: E731
            plain = lambda: cuda_ops.scatter_rows_set_2d_plain(  # noqa
                **a)
            lib = lambda: rows.index_copy_(0, safe, src)  # noqa: E731
            # kernel 2's bound as in phase 1: each valid row read and
            # written once, plus the indices; the old count beside it
            inp = row_sweep.ScatterInput(a)
            nbytes = row_sweep.scatter_bytes(inp)
            old = row_sweep.scatter_bytes_every_row(inp)
            del inp
        if err:
            raise AssertionError(f"row_{kind} on an f64 step's operands: "
                                 f"{err} words apart")
        res[kind] = {"n": n, "row_bytes": row_b, "ch": ch,
                     "trash_share": 1.0 - float(valid.float().mean()),
                     "max_abs_err": err, "ms": _time_ms(torch, fn, 20),
                     "plain_ms": _time_ms(torch, plain, 5),
                     "library_ms": _time_ms(torch, lib, 20),
                     "bound_ms": nbytes / rate * 1e3, "bytes": nbytes}
        if kind == "scatter":
            res[kind].update(old_bound_ms=old / rate * 1e3, old_bytes=old)
        torch.cuda.empty_cache()
    return res


def dtypes_phase(torch, cuda_ops, dev, seed, rate):
    """Phase 12: the 64-bit and bool value dtypes at the table step's
    width (module docstring)."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    tables, keys, out = _dtypes_fill(torch, cuda_ops, de, dev, gen, seed)
    out["train"], own = _dtypes_train(torch, cuda_ops, de, tables, keys,
                                      dev, gen, seed)
    del tables["float32"]
    torch.cuda.empty_cache()
    out["own_calls"] = _dtypes_own_calls(torch, cuda_ops, own, rate)
    del own
    torch.cuda.empty_cache()
    out["narrow"] = _dtypes_narrow(torch, de, dev, seed)
    with tempfile.TemporaryDirectory() as tmp:
        out["checkpoint"] = _dtypes_checkpoint(torch, cuda_ops, tables, tmp)
    del tables
    torch.cuda.empty_cache()
    out["launches"] = {
        **{f"dtypes_fill_{n}": out[n]["launches_fill"]
           for n in ("float64", "int64", "bool")},
        **{f"dtypes_lookup_{n}": out[n]["launches_lookup"]
           for n in ("float64", "int64", "bool")},
        "dtypes_train_float64": out["train"]["float64"]["launches"],
        "dtypes_checkpoint": out["checkpoint"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# 13. the input pipeline, profiling
# ---------------------------------------------------------------------------


def write_criteo_tsv(path, n, seed):
    """``n`` Criteo-format lines whose label follows a hot categorical
    token 90% of the time (tests/test_data.py's learnable file)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 2, n)
    label = np.where(rng.random(n) < 0.9, hot, 1 - hot)
    dense = rng.integers(0, 100, (n, 13)).astype(str)
    cats = np.char.add("v", rng.integers(0, 50, (n, 26)).astype(str))
    cats[:, 0] = np.char.add("hot", hot.astype(str))
    rows = np.concatenate([label.astype(str)[:, None], dense, cats], axis=1)
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in rows.tolist()) + "\n")


def write_movielens_ratings(path, n, seed):
    """``n`` ratings with a latent structure (user x movie parity), as
    tests/test_data.py writes them."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, 200, n)
    m = rng.integers(1, 300, n)
    r = np.where((u + m) % 2 == 0, 4.0, 2.0)
    with open(path, "w") as f:
        f.write("".join(f"{a}::{b}::{c}::978300760\n"
                        for a, b, c in zip(u, m, r)))


def _run_main(main, argv):
    """``main(argv)`` with its standard output captured: ``(rc, text,
    seconds)``."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def _last_number(text, marker):
    line = [ln for ln in text.splitlines() if marker in ln][-1]
    return float(line.rsplit(" ", 1)[1])


def _examples_per_s(text) -> float:
    line = [ln for ln in text.splitlines() if "examples/s" in ln][-1]
    return float(line.split("(")[1].split()[0].replace(",", ""))


def _dlrm_example(torch, cuda_ops, argv, what):
    """dlrm_train.main(argv) with its final loss read from train_loop's
    report; returns its output, the loss and the launch counts."""
    from recommenders_addons_tpu_torch.examples import dlrm_train

    real, seen = dlrm_train.train_loop, {}

    def recording(*a, **kw):
        state, report = real(*a, **kw)
        seen["loss"] = report.last_metrics["loss"]
        return state, report

    cuda_ops.reset_launches()
    dlrm_train.train_loop = recording
    try:
        rc, text, secs = _run_main(dlrm_train.main, argv)
    finally:
        dlrm_train.train_loop = real
    launches = _launched(cuda_ops, what, ("row_gather",
                                          "fused_update_scatter"), "data")
    if rc != 0 or not math.isfinite(seen.get("loss", float("nan"))):
        raise AssertionError(f"data {what}: rc {rc}, loss "
                             f"{seen.get('loss')}\n{text[-2000:]}")
    auc = _last_number(text, "AUC (")
    return {"rc": rc, "s": secs, "loss": seen["loss"], "auc": auc,
            "examples_per_s": _examples_per_s(text), "launches": launches,
            "lines": [ln for ln in text.splitlines()
                      if "steps in" in ln or ln.startswith("AUC")]}


def _profile_dlrm(torch, cuda_ops, dev, path, tmp):
    """profiling.trace around DATA_PROFILE_STEPS full-width DLRM steps fed
    by the reader: the trace holds row_gather, the fused apply and the
    annotate range; then StepTimer beside CUDA events on more steps."""
    import itertools
    import json as _json
    import os

    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.data import CriteoTSVReader, prefetch
    from recommenders_addons_tpu_torch.models import dlrm
    from recommenders_addons_tpu_torch.utils import profiling

    model = dlrm.DLRM(dlrm.DLRMConfig(), device=dev)
    st = model.init(0)
    st.table = de.create_slots(model.var, st.table, model.opt)
    step, tx = model.make_train_step()
    opt = tx.init(list(st.dense.parameters()))
    # every batch read first: the reader thread, which holds the
    # interpreter lock while it parses, has stopped before the steps
    n = 2 + DATA_PROFILE_STEPS + DATA_TIMER_STEPS
    batches = list(prefetch(itertools.islice(CriteoTSVReader(
        path, batch_size=DLRM_BATCH, repeat=True), n), device=dev))
    for b in batches[:2]:  # warm
        st, opt, loss = step(st, opt, b)
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    with profiling.trace(tmp) as prof:
        for b in batches[2:2 + DATA_PROFILE_STEPS]:
            with profiling.annotate("dlrm_train_step"):
                st, opt, loss = step(st, opt, b)
        torch.cuda.synchronize()
    launches = _launched(cuda_ops, "profile", ("row_gather",
                                               "fused_update_scatter"),
                         "data")
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in _json.load(f)["traceEvents"]}
    want = {"row_gather": "row_gather_kernel",
            "fused_update_scatter": "fused_kernel",
            "annotate": "dlrm_train_step"}
    hits = {k: any(v in nm for nm in names) for k, v in want.items()}
    if not all(hits.values()):
        raise AssertionError(f"the profiler trace lacks {hits}")
    timer = profiling.StepTimer()
    ev = []
    torch.cuda.synchronize()
    for b in batches[2 + DATA_PROFILE_STEPS:]:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        timer.start()
        e0.record()
        st, opt, loss = step(st, opt, b)
        e1.record()
        timer.stop(loss)
        ev.append(e0.elapsed_time(e1))
    return {"trace_mb": os.path.getsize(prof.trace_path) / 1e6,
            "trace_events": len(names), "trace_has": hits,
            "launches": launches, "step_timer_mean_ms": timer.mean_ms,
            "cuda_event_mean_ms": float(np.mean(ev)),
            "steps": DATA_TIMER_STEPS, "loss": float(loss)}


def data_phase(torch, cuda_ops, dev, seed):
    """Phase 13: the reader, prefetch, the reader-fed examples and the
    profiling helpers (module docstring)."""
    import os

    from recommenders_addons_tpu_torch.data import CriteoTSVReader
    from recommenders_addons_tpu_torch.examples import movielens_train

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "day.tsv")
        t0 = time.perf_counter()
        write_criteo_tsv(path, DATA_LINES, seed)
        out["file"] = {"lines": DATA_LINES, "mb": os.path.getsize(path)
                       / 1e6, "write_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        rows = sum(len(b["label"]) for b in CriteoTSVReader(
            path, batch_size=DLRM_BATCH))
        secs = time.perf_counter() - t0
        if rows != DATA_LINES:
            raise AssertionError(f"the reader read {rows} rows")
        out["reader_rows_per_s"] = rows / secs

        common = ["--steps", str(DATA_STEPS), "--batch-size",
                  str(DLRM_BATCH), "--dim", str(DIM), "--eval-batches", "2",
                  "--device", "cuda"]
        out["dlrm_file"] = _dlrm_example(torch, cuda_ops,
                                         ["--data", path] + common,
                                         "dlrm_file")
        torch.cuda.empty_cache()
        out["dlrm_synthetic"] = _dlrm_example(torch, cuda_ops, common,
                                              "dlrm_synthetic")
        torch.cuda.empty_cache()
        for k in ("dlrm_file", "dlrm_synthetic"):
            out[k]["ms_per_step"] = DLRM_BATCH / out[k][
                "examples_per_s"] * 1e3

        small = os.path.join(tmp, "small.tsv")
        write_criteo_tsv(small, 2000, seed + 1)
        out["dlrm_auc_bar"] = _dlrm_example(
            torch, cuda_ops, ["--data", small, "--steps", "60",
                              "--batch-size", "256", "--dim", "8",
                              "--eval-batches", "2", "--device", "cuda"],
            "dlrm_auc_bar")
        if not out["dlrm_auc_bar"]["auc"] > 0.8:
            raise AssertionError(f"the reader-fed DLRM's AUC "
                                 f"{out['dlrm_auc_bar']['auc']} <= 0.8")
        torch.cuda.empty_cache()

        ratings = os.path.join(tmp, "ratings.dat")
        write_movielens_ratings(ratings, 4000, seed + 2)
        cuda_ops.reset_launches()
        rc, text, secs = _run_main(movielens_train.main, [
            "--data", ratings, "--steps", "80", "--batch-size", "256",
            "--eval-batches", "2", "--device", "cuda"])
        mse = _last_number(text, "eval_mse (")
        if rc != 0 or not mse < 0.8:
            raise AssertionError(f"movielens_train: rc {rc}, eval MSE {mse}")
        out["movielens"] = {"rc": rc, "s": secs, "eval_mse": mse,
                            "launches": _launched(
                                cuda_ops, "movielens", (
                                    "row_gather", "fused_update_scatter"),
                                "data")}
        out["profile"] = _profile_dlrm(torch, cuda_ops, dev, path,
                                       os.path.join(tmp, "trace"))
    torch.cuda.empty_cache()
    out["launches"] = {f"data_{k}": out[k]["launches"] for k in (
        "dlrm_file", "dlrm_synthetic", "dlrm_auc_bar", "movielens",
        "profile")}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# 14. the other seven examples
# ---------------------------------------------------------------------------

# example -> (its result-line markers, a check of its output)
EXAMPLES = {
    "fp16_compress_serving": (["rows as fp16", "served lookup: 8/8 found"],
                              None),
    "warm_start_train": (["phase 1 trained eval_mse=",
                          "-> warm-started eval_mse="], None),
    "restrict_growth": (["step 60: loss=", "final live keys: "],
                        lambda t: "cap honored: True" in t),
    "bpv2_train": (["assign-mode  loss:", "bp_v2 (delta) loss:"],
                   lambda t: "single-writer rows agree: True" in t),
    "terabyte_hybrid": (["device live:", "restored: device"],
                        lambda t: "every row survived" in t),
    "retrieval_train": (["final: loss=", "group-recall@10="], None),
    "seq_and_dense_train": (["final: train_mse=", " eval_mse="], None),
}


def examples_phase(torch, cuda_ops):
    """Phase 14: each example's main at its own defaults on the card."""
    import importlib

    t_phase = time.perf_counter()
    out = {}
    for name, (markers, check) in EXAMPLES.items():
        mod = importlib.import_module(
            f"recommenders_addons_tpu_torch.examples.{name}")
        cuda_ops.reset_launches()
        rc, text, secs = _run_main(mod.main, ["--device", "cuda"])
        launches = {k.name: k.launches for k in cuda_ops.KERNELS}
        lines = text.splitlines()
        if rc != 0 or any(m not in text for m in markers) or (
                check is not None and not check(text)):
            raise AssertionError(f"example {name}: rc {rc}\n{text[-2000:]}")
        if not (launches["row_gather"] or launches["row_scatter"]):
            raise AssertionError(f"example {name} launched no row kernel")
        out[name] = {"rc": rc, "s": secs, "launches": launches,
                     "result_lines": [ln for ln in lines
                                      if any(m in ln for m in markers)]}
        torch.cuda.empty_cache()
    out["launches"] = {f"examples_{k}": v["launches"] for k, v in
                       out.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from recommenders_addons_tpu_torch.ops import cuda_ops
        from recommenders_addons_tpu_torch.tools.dma_bench import mem_rate
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1

    card = _card_line()
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    dev = torch.device("cuda")
    from recommenders_addons_tpu_torch import native

    native_build = {}

    def build_native():  # g++ for the host store, beside the nvcc builds
        t = time.perf_counter()
        try:
            native.get_lib()
        except RuntimeError as e:
            native_build["error"] = e
        native_build["s"] = time.perf_counter() - t

    builder = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    builder.start()
    cuda_ops.build_kernels()  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    builder.join()
    if "error" in native_build:
        raise native_build["error"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    kernels = kernel_phase(torch, cuda_ops, dev, gen, rate)
    kernels.append(fused_kernel_phase(torch, cuda_ops, dev, gen, rate,
                                      args.seed))
    kernels.append(_init_rows_kernel(torch, cuda_ops, dev, gen, rate))
    serving = serving_phase(torch, cuda_ops, dev, gen, args.seed)
    training = training_phase(torch, cuda_ops, dev, args.seed)
    torch.cuda.empty_cache()
    table_step = table_step_phase(torch, cuda_ops, dev, args.seed)
    torch.cuda.empty_cache()
    optax = optax_phase(torch, cuda_ops, dev, args.seed)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    surface = training_surface_phase(torch, cuda_ops, dev, args.seed)
    surface["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    models = models_phase(torch, cuda_ops, dev, args.seed)
    models["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    life = lifecycle_phase(torch, cuda_ops, dev, args.seed)
    life["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    sharded = sharded_phase(torch, cuda_ops, dev, args.seed)
    torch.cuda.empty_cache()
    spill = spill_phase(torch, cuda_ops, dev, args.seed)
    spill["native_build_s"] = native_build["s"]
    torch.cuda.empty_cache()
    dtypes = dtypes_phase(torch, cuda_ops, dev, args.seed, rate)
    torch.cuda.empty_cache()
    data = data_phase(torch, cuda_ops, dev, args.seed)
    torch.cuda.empty_cache()
    examples = examples_phase(torch, cuda_ops)
    torch.cuda.empty_cache()
    dma_kernels, dma = dma_bench_phase(torch, cuda_ops, dev, gen, card)
    kernels += dma_kernels
    torch.cuda.empty_cache()
    ab_kernels, ab = ab_tools_phase(torch, cuda_ops, dev, gen, rate, card)
    kernels += ab_kernels
    paths = {"serving": serving["launches"],
             "serving_grpc": serving["grpc"]["launches"],
             "dlrm_training": training["launches"],
             "table_step": table_step["launches"], **optax["launches"],
             **{f"training_surface_{p}": n
                for p, n in surface["launches"].items()},
             "models_dcn": models["dcn"]["launches"],
             "models_sparse_api": models["sparse_api"]["launches"],
             "models_learning_bars": models["learning_bars"]["launches"],
             "models_dcnv2": models["dcnv2"]["launches"],
             "lifecycle": life["launches"], **sharded["launches"],
             **spill["launches"], **dtypes["launches"],
             **data["launches"], **examples["launches"],
             "dma_bench": dma["launches"], **ab["launches"]}
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["card"] = card
        if k["name"] == "row_gather":
            k["dcn_step_max_abs_err"] = models["dcn"][
                "row_gather_own_calls_max_abs_err"]
            k["sharded_step_max_abs_err"] = sharded["full_width"][
                "row_gather_own_calls_max_abs_err"]
            k["f64_step"] = dtypes["own_calls"]["gather"]
            k["dcnv2_step_max_abs_err"] = max(
                models["dcnv2"][b]["row_gather_own_calls_max_abs_err"]
                for b in ("miss", "hit"))
        if k["name"] == "row_scatter":
            k["f64_step"] = dtypes["own_calls"]["scatter"]
        if k["name"] == "fused_update_scatter":
            k["dcn_step_ulps_max_abs_err"] = models["dcn"][
                "fused_own_call_ulps_max_abs_err"]
            k["sharded_step_ulps_max_abs_err"] = sharded["full_width"][
                "fused_own_call_ulps_max_abs_err"]
            k["dcnv2_step_ulps_max_abs_err"] = [
                max(models["dcnv2"][b]["fused_own_call_ulps_max_abs_err"][i]
                    for b in ("miss", "hit")) for i in (0, 1)]
        if k["name"] == "init_rows":
            k["dcnv2_step_calls"] = models["dcnv2"]["miss"][
                "init_rows_own_calls"]
    if "jax" in sys.modules or "recommenders_addons_tpu" in sys.modules:
        raise AssertionError("the port run imported JAX or the JAX package")
    if "grpc" in sys.modules:
        raise AssertionError("the port run imported grpc")

    print(card)
    print(json.dumps({"serving": dict(serving, build_s=build_s,
                                      mem_bytes_per_s=rate, card=card)}))
    print(json.dumps({"training": dict(training, table_step=table_step,
                                       card=card)}))
    print(json.dumps({"optax": dict(optax, card=card)}))
    print(json.dumps({"training_surface": dict(surface, card=card)}))
    print(json.dumps({"models": dict(models, card=card)}))
    print(json.dumps({"lifecycle": dict(life, card=card)}))
    print(json.dumps({"sharded": dict(sharded, card=card)}))
    print(json.dumps({"spill": dict(spill, card=card)}))
    print(json.dumps({"dtypes": dict(dtypes, card=card)}))
    print(json.dumps({"data": dict(data, card=card)}))
    print(json.dumps({"examples": dict(examples, card=card)}))
    print(json.dumps({"dma_bench": dma}))
    print(json.dumps({"ab_tools": ab}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
