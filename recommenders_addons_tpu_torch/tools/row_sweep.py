"""Timing of the row gather and the row scatter on an NVIDIA card:
``row_gather`` (``csrc/row_gather.cu``, kernel 1 of the port) and
``row_scatter`` (``csrc/row_scatter.cu``, kernel 2), at the inputs they
are judged by.

    python -m recommenders_addons_tpu_torch.tools.row_sweep \\
        [--baseline DIR] [NAME=VALUE[,NAME=VALUE ...] ...]

The versions timed are this tree's two kernels; ``--baseline DIR``,
another tree's ``csrc/`` (a ``git archive`` of the parent unpacked under
``build/``), timed first and last; and one version per positional
argument, a copy of this tree's two sources under ``build/row_sweep/``
with the named ``constexpr int`` constants rewritten (each found once in
each source), e.g. ``kDepth=4`` or ``kDepth=16,kBlocksPerSm=4``. Copies
are built with the package's nvcc flags, a few at a time. Beside them,
the bulk-copy ring of kernels 4-5 (``dma_bench``'s gathers, one
``cp.async.bulk`` a row into a shared-memory ring) is timed on every
gather input whose rows are copied whole and whose indices all lie in
the table, the other design for kernel 1.

The inputs:

* gather (a) serving: C = 4Mi rows of 512 B (ch = vc = 1), N = 65,536
  uniform indices, every 97th the sentinel C (the trash row);
* gather (b) the table step's width: 2Mi slots, ch = vc = 2, the same
  indices' pattern;
* gather (c) and scatter (b): the row gather and the writeback scatter
  of the tenth f64 Adam step (:func:`f64_step_calls`: dim 64 with Adam
  slots, 2 KiB rows, ch 4 in the kernels' int32 view, as
  ``chip_smoke.py``'s dtypes phase builds them), about 70% of the
  writeback's rows bound for the trash row;
* gather (d) one full-width DLRM step's own call
  (:func:`dlrm_step_gather`, the second step of a fresh model);
* scatter (a) the load shape: 1Mi unique rows of 512 B into C = 4Mi,
  every 64th the sentinel;
* scatter (c) ch = 2, 65,536 unique rows into 2Mi slots, every 64th the
  sentinel;
* scatter (d) scatter (b)'s operands with every index the sentinel.

Each version is first held bit-exact against the plain version at every
input (the scatter on rows ``[0, cap)``; rows not named stay as they
were), then timed as ``dma_bench`` times a call (``dma_bench.call_ms``:
20 back-to-back calls, CUDA events behind a device spin). The plain
version and one PyTorch call of the same function (``index_select`` /
``index_copy_``) are timed once per input. Each input's bytes bound
counts what its data needs (:func:`gather_bytes`, :func:`scatter_bytes`)
over the card's memory rate; the scatter's bound by the count every
input row read (``old_bound_ms``) is printed beside it. Prints one line
per version and last one JSON object with every time, each bound, the
library call's, the trash share of each input and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
from pathlib import Path

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.tools import (
    dma_bench,
    fused_sweep,
    gather_sweep,
)
from recommenders_addons_tpu_torch.utils.config import resolve_device

_LANES = 128
_CHUNK_BYTES = _LANES * 4
_BUILD_AT_ONCE = 8
_SWEEP_DIR = cuda_ops._BUILD_DIR.parent / "row_sweep"
_KERNELS = (cuda_ops.ROW_GATHER, cuda_ops.ROW_SCATTER)
# the bulk-copy ring's gathers timed beside kernel 1 (dma_bench.VARIANTS)
RING_VARIANTS = ("grouped g16 x 8sem", "unroll16  nbuf32 premul")
C = 1 << 22  # DLRMConfig.table_capacity: the serving and load shapes
TABLE_CAP = 1 << 21  # bench.py's table step
N = 65536
N_LOAD = 1 << 20
F64_KEYS, F64_BLOCK, F64_STEPS, DIM = 1 << 20, 65536, 10, 64


def copy_kernels(name: str, src: Path, consts: dict) -> dict:
    """The two row kernels of ``src`` copied to ``build/row_sweep/name``
    with ``consts`` rewritten (each found once in each source), as kernels
    that build from there, by name."""
    dest = _SWEEP_DIR / name
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    for header in src.glob("*.cuh"):
        shutil.copy(header, dest)
    kernels = {}
    for k in _KERNELS:
        text = (src / f"{k.name}.cu").read_text()
        for const, value in consts.items():
            text, hits = re.subn(rf"constexpr int {const} = [^;]*;",
                                 f"constexpr int {const} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"{k.name}.cu: no single {const}")
        (dest / f"{k.name}.cu").write_text(text)
        copy = cuda_ops._Kernel(k.name, k.argtypes)
        copy.source = dest / f"{k.name}.cu"
        kernels[k.name] = copy
    return kernels


def parse_consts(arg: str) -> dict:
    """``"kDepth=4,kBlocksPerSm=2"`` -> ``{"kDepth": "4", ...}``."""
    out = {}
    for part in arg.split(","):
        name, sep, value = part.partition("=")
        if not sep or not re.fullmatch(r"k\w+", name) or not value:
            raise ValueError(f"not NAME=VALUE: {part!r}")
        out[name] = value
    return out


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatherInput:
    """One call of ``gather_rows_2d`` by its arguments (as
    ``fused_sweep.record_calls`` records them)."""

    kw: dict

    def __post_init__(self):
        k = self.kw
        (self.t32, self.ch, self.vc, self.nrows, self.cap, self.masked,
         self.idx) = cuda_ops._gather_args(
            k["table2d"], k["ch"], k["idx"], k.get("cap"),
            k.get("masked", True), k.get("flat", False), k.get("vc"))

    def args(self):
        return (self.t32, self.ch, self.vc, self.nrows, self.cap,
                self.masked, self.idx)

    def call(self, kernel):
        return cuda_ops._gather_cuda(*self.args(), kernel=kernel)

    def plain(self):
        return cuda_ops._gather_plain(*self.args())

    def library(self):
        """``index_select`` of the clamped rows' leading vc chunks: the
        same function where unmasked."""
        rows = self.t32.view(self.nrows, self.ch * _LANES)
        return torch.index_select(rows[:, :self.vc * _LANES], 0,
                                  self._safe())

    def _safe(self):
        return self.idx.to(torch.int64).clamp(0, self.nrows - 1)

    def trash_share(self) -> float:
        """Share of rows that read the trash row (the table's last), or
        none (clamped or masked indices)."""
        i = self.idx
        return 1.0 - float(((i >= 0) & (i < self.nrows - 1)).float().mean())

    def whole_rows_in_table(self) -> bool:
        i = self.idx
        return (self.vc == self.ch and not self.masked
                and bool(((i >= 0) & (i < self.nrows)).all()))

    def info(self) -> dict:
        return {"nrows": self.nrows, "ch": self.ch, "vc": self.vc,
                "n": self.idx.shape[0], "masked": bool(self.masked),
                "trash_share": self.trash_share()}


def gather_bytes(inp: GatherInput) -> int:
    """Bytes the gather must move: each distinct row it reads (vc chunks)
    once, every output row written, 4 B an index. A masked-off row is
    written, never read."""
    i = inp.idx.to(torch.int64)
    if inp.masked:
        i = i[(i >= 0) & (i < inp.cap)]
    read = int(torch.unique(i.clamp(0, inp.nrows - 1)).numel())
    n = inp.idx.shape[0]
    return (read + n) * inp.vc * _CHUNK_BYTES + 4 * n


@dataclasses.dataclass
class ScatterInput:
    """One call of ``scatter_rows_set_2d`` by its arguments."""

    kw: dict

    def __post_init__(self):
        k = self.kw
        self.table = k["table2d"]
        (self.t32, self.ch, self.cap, self.idx,
         self.rows32) = cuda_ops._scatter_args(
            k["table2d"], k["ch"], k["idx"], k["rows"], k.get("cap"))

    def call(self, kernel, t32=None):
        cuda_ops._scatter_cuda(self.t32 if t32 is None else t32, self.ch,
                               self.cap, self.idx, self.rows32,
                               kernel=kernel)

    def plain(self, t32=None):
        cuda_ops._scatter_plain(self.t32 if t32 is None else t32, self.ch,
                                self.cap, self.idx, self.rows32)

    def valid(self) -> torch.Tensor:
        return (self.idx >= 0) & (self.idx < self.cap)

    def library(self, t32=None):
        """``index_copy_`` of every row, the invalid ones to the trash
        row."""
        t32 = self.t32 if t32 is None else t32
        n = self.idx.shape[0]
        safe = torch.where(self.valid(), self.idx.to(torch.int64), self.cap)
        return t32.view(-1, self.ch * _LANES).index_copy_(
            0, safe, self.rows32.view(n, self.ch * _LANES))

    def trash_share(self) -> float:
        return 1.0 - float(self.valid().float().mean())

    def info(self) -> dict:
        return {"cap": self.cap, "ch": self.ch, "n": self.idx.shape[0],
                "trash_share": self.trash_share()}

    def all_trash(self) -> "ScatterInput":
        """These operands with every index the sentinel ``cap``."""
        return ScatterInput(dict(self.kw, idx=torch.full_like(
            self.kw["idx"], self.cap)))


def scatter_bytes(inp: ScatterInput) -> int:
    """Bytes the scatter must move: each row with a valid index read once
    and written once (ch chunks each), 4 B an index. Rows bound for the
    trash row need not move."""
    valid = int(inp.valid().sum())
    return 2 * valid * inp.ch * _CHUNK_BYTES + 4 * inp.idx.shape[0]


def scatter_bytes_every_row(inp: ScatterInput) -> int:
    """The count the port used until the trash rows were skipped: every
    input row read, each distinct target row (the trash row among them)
    written once, 4 B an index."""
    n = inp.idx.shape[0]
    safe = torch.where(inp.valid(), inp.idx, inp.cap)
    written = int(torch.unique(safe).numel())
    return (n + written) * inp.ch * _CHUNK_BYTES + 4 * n


def _random_table(rows: int, ch: int, dev, gen) -> torch.Tensor:
    """A physical ``[rows*ch, 128]`` f32 container of random bits."""
    return torch.randint(-(1 << 31), (1 << 31) - 1, (rows * ch, _LANES),
                         dtype=torch.int32, device=dev,
                         generator=gen).view(torch.float32)


def gather_input(dev, gen, cap: int, ch: int, n: int = N) -> GatherInput:
    """Uniform indices into a ``cap``-row table with a trash row, every
    97th the sentinel ``cap``; unmasked, whole rows."""
    table = _random_table(cap + 1, ch, dev, gen)
    idx = torch.randint(0, cap, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    idx[::97] = cap
    return GatherInput(dict(table2d=table, ch=ch, idx=idx, cap=None,
                            masked=False, flat=False, vc=None))


def scatter_input(dev, gen, cap: int, ch: int, n: int,
                  table: torch.Tensor | None = None) -> ScatterInput:
    """``n`` unique slots of a ``cap``-row table (``table``, or a new
    random one), every 64th the sentinel ``cap``, random rows."""
    if table is None:
        table = _random_table(cap + 1, ch, dev, gen)
    idx = torch.randperm(cap, device=dev, generator=gen)[:n].to(torch.int32)
    idx[::64] = cap
    rows = _random_table(n, ch, dev, gen).view(n, ch * _LANES)
    return ScatterInput(dict(table2d=table, ch=ch, idx=idx, rows=rows,
                             cap=cap))


def f64_step_calls(dev, seed: int = 0, cap: int = TABLE_CAP,
                   keys: int = F64_KEYS, block: int = F64_BLOCK,
                   dim: int = DIM, steps: int = F64_STEPS):
    """The first row gather and row scatter of the last of ``steps`` Adam
    steps on an f64 table, as ``chip_smoke.py``'s dtypes phase makes
    them: ``cap`` slots of dim ``dim`` with Adam slots (2 KiB rows at dim
    64), ``keys`` keys upserted in blocks of ``block``, then steps of
    ``block`` zipf(1.2) ids of them, a tenth fresh keys. Returns
    (GatherInput, ScatterInput), their tensors copied before the
    call."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    var = de.Variable(name="row_sweep_f64", dim=dim, init_capacity=cap,
                      value_dtype=torch.float64,
                      initializer=de.initializers.normal(0.05), device=dev)
    opt = de.Adam(0.001)
    st = de.create_slots(var, var.init(), opt)
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.choice(1 << 40, size=keys, replace=False)
                         .astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for off in range(0, keys, block):
        vals = torch.randn((min(block, keys - off), dim),
                           dtype=torch.float64, device=dev, generator=gen)
        st = var.upsert(st, k[off:off + block], vals)
    perm = torch.from_numpy(rng.permutation(keys)).to(dev)
    seen = {}
    for t in range(steps):
        z = torch.from_numpy((rng.zipf(1.2, block) - 1) % keys).to(dev)
        ids = k[perm[z]]
        ids[: block // 10] = torch.from_numpy(
            rng.integers(1 << 41, 1 << 42, block // 10)).to(dev)
        g = torch.randn((block, dim), dtype=torch.float64, device=dev,
                        generator=gen)

        def step(st=st, ids=ids, g=g, t=t):
            emb, ctx = var.embedding_lookup(st, ids, step=t + 1)
            return var.apply_gradients(st, ctx, g.to(emb.dtype), opt,
                                       step=t)

        if t < steps - 1:
            st = step()
            continue
        seen["gather"] = fused_sweep.record_calls(
            lambda: seen.__setitem__("scatter", fused_sweep.record_calls(
                step, "scatter_rows_set_2d", limit=1)),
            "gather_rows_2d", limit=1)
    if not (seen["gather"] and seen["scatter"]):
        raise AssertionError("the f64 step made no row gather or scatter")
    return GatherInput(seen["gather"][0]), ScatterInput(seen["scatter"][0])


def dlrm_step_gather(dev, seed: int = 0, cfg=None,
                     batch: int = 4096) -> GatherInput:
    """The first row gather of one DLRM training step (``cfg``, default
    the full-width ``DLRMConfig()``): the second step of a fresh model
    with its Adagrad slots (the first finds no key, so gathers no row),
    on ``synthetic_criteo_batch`` at ``seed + 1``; its tensors copied
    before the call."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.models import dlrm

    model = dlrm.DLRM(cfg or dlrm.DLRMConfig(), device=dev)
    state = model.init(seed)
    state = dataclasses.replace(
        state, table=de.create_slots(model.var, state.table, model.opt))
    train_step, tx = model.make_train_step()
    opt_state = tx.init(list(state.dense.parameters()))
    batches = []
    for s in (seed, seed + 1):
        b = dlrm.synthetic_criteo_batch(np.random.default_rng(s), batch)
        batches.append({k: torch.from_numpy(v).to(dev)
                        for k, v in b.items()})
    state, opt_state, _ = train_step(state, opt_state, batches[0])
    seen = fused_sweep.record_calls(
        lambda: train_step(state, opt_state, batches[1]),
        "gather_rows_2d", limit=1)
    if not seen:
        raise AssertionError("a DLRM step made no row gather")
    return GatherInput(seen[0])


def sweep_inputs(dev, seed: int = 0) -> dict:
    """Every input by name (``gather_a`` ... ``scatter_d``), made on
    ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64_gather, f64_scatter = f64_step_calls(dev, seed)
    ga = gather_input(dev, gen, C, 1)
    return {
        "gather_a": ga,
        "gather_b": gather_input(dev, gen, TABLE_CAP, 2),
        "gather_c": f64_gather,
        "gather_d": dlrm_step_gather(dev, seed),
        "scatter_a": scatter_input(dev, gen, C, 1, N_LOAD,
                                   table=ga.kw["table2d"]),
        "scatter_b": f64_scatter,
        "scatter_c": scatter_input(dev, gen, TABLE_CAP, 2, N),
        "scatter_d": f64_scatter.all_trash(),
    }


# ---------------------------------------------------------------------------
# checks and timing
# ---------------------------------------------------------------------------


def check_gather(inp: GatherInput, want: torch.Tensor, kernel, what: str):
    got = inp.call(kernel)
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the gather disagrees with its plain "
                             f"version")


def check_scatter(inp: ScatterInput, want: torch.Tensor, kernel, what: str):
    """Rows [0, cap) bit-exact against the plain version (so rows not
    named keep their bits)."""
    got = inp.t32.clone()
    inp.call(kernel, got)
    live = inp.cap * inp.ch
    if not torch.equal(got[:live], want[:live]):
        raise AssertionError(f"{what}: the scatter disagrees with its "
                             f"plain version on rows [0, cap)")


def _ring_ms(inp: GatherInput, want: torch.Tensor, dev) -> dict:
    """ms of the bulk-copy ring's gathers (kernels 4-5) on ``inp``, each
    first held bit-exact against kernel 1's plain version."""
    out = {}
    table = inp.t32
    for name, kw in dma_bench.VARIANTS:
        if name not in RING_VARIANTS:
            continue
        fn = dma_bench.make_variant(kw, ch=inp.ch, scatter=False)
        got = fn(table, inp.idx).view(torch.int32)
        if not torch.equal(got.reshape(-1), want.reshape(-1)):
            raise AssertionError(f"ring {name} disagrees with kernel 1's "
                                 f"plain version")
        out[name] = dma_bench.call_ms(lambda: fn(table, inp.idx), dev)
    return out


def main(argv=None, *, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path, default=None,
                   help="another tree's csrc/ directory, timed first and "
                        "last")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("variants", nargs="*",
                   help="NAME=VALUE[,NAME=VALUE...]: a copy of this tree's "
                        "sources with those constants rewritten")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the sweep times CUDA kernels: it needs a card")
    src = cuda_ops._PKG / "csrc"
    versions = {}
    if args.baseline is not None:
        versions["baseline"] = copy_kernels("baseline", args.baseline, {})
    versions["this tree"] = {k.name: k for k in _KERNELS}
    for i, v in enumerate(args.variants):
        consts = parse_consts(v)
        versions[" ".join(f"{k}={x}" for k, x in consts.items())] = (
            copy_kernels(f"v{i}", src, consts))
    if args.baseline is not None:
        versions["baseline again"] = versions["baseline"]
    # one build per library (copies of one source share its name)
    todo = list({k.library: k for ks in versions.values()
                 for k in ks.values()}.values())
    for i in range(0, len(todo), _BUILD_AT_ONCE):
        cuda_ops.build_kernels(todo[i:i + _BUILD_AT_ONCE])
    card = gather_sweep._card()
    print(card, flush=True)
    rate = dma_bench.mem_rate(torch.cuda.get_device_name(0))
    inputs = sweep_inputs(dev, args.seed)
    result = {"card": card, "inputs": {}, "versions": {}, "ring": {}}
    wants = {}
    for key, inp in inputs.items():
        info = inp.info()
        if key.startswith("gather"):
            wants[key] = inp.plain()
            nbytes = gather_bytes(inp)
            info.update(plain_ms=dma_bench.call_ms(inp.plain, dev, 5),
                        library_ms=dma_bench.call_ms(inp.library, dev),
                        library_call="torch.index_select")
            if inp.whole_rows_in_table():
                result["ring"][key] = _ring_ms(inp, wants[key], dev)
        else:
            want = inp.t32.clone()
            inp.plain(want)
            wants[key] = want
            nbytes = scatter_bytes(inp)
            work = inp.t32.clone()
            old = scatter_bytes_every_row(inp)
            info.update(plain_ms=dma_bench.call_ms(
                lambda: inp.plain(work), dev, 5),
                library_ms=dma_bench.call_ms(lambda: inp.library(work), dev),
                library_call="torch.Tensor.index_copy_",
                old_bytes=old, old_bound_ms=old / rate * 1e3)
            del work
        info.update(bytes=nbytes, bound_ms=nbytes / rate * 1e3)
        result["inputs"][key] = info
        print(f"{key}: " + json.dumps(info), flush=True)
    if result["ring"]:
        print("ring: " + json.dumps(result["ring"]), flush=True)
    for version, kernels in versions.items():
        row = {}
        for key, inp in inputs.items():
            if key.startswith("gather"):
                k = kernels["row_gather"]
                check_gather(inp, wants[key], k, f"{version} ({key})")
                row[key] = dma_bench.call_ms(lambda: inp.call(k), dev)
            else:
                k = kernels["row_scatter"]
                check_scatter(inp, wants[key], k, f"{version} ({key})")
                work = inp.t32.clone()
                row[key] = dma_bench.call_ms(lambda: inp.call(k, work), dev)
                del work
        result["versions"][version] = row
        print(f"{version:>16}: " + "  ".join(
            f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
