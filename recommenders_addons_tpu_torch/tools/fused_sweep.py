"""Ring-geometry sweep of the fused optimizer-scatter on an NVIDIA card:
``fused_update_scatter`` (``csrc/fused_update_scatter.cu``), kernel 3 of
the port, at the three inputs it is judged by.

    python -m recommenders_addons_tpu_torch.tools.fused_sweep \\
        [--baseline DIR] [KIB,STAGES,BLOCKS,CONSUMERS ...]

A geometry is a stage size in KiB, the stages in the ring, the cap on
resident blocks per SM and the consumer warps per block: the constants
``kStageBytes``, ``kStages``, ``kBlocksPerSm`` and ``kConsumers`` of the
source. Each is a copy of ``csrc/`` under ``build/fused_sweep/`` with
those constants rewritten; the copies are built with the package's nvcc
flags, a few at a time. The default list is every combination of
16/32/64 KiB stages, 2 or 4 stages, 1-3 blocks per SM and 4 or 8
consumer warps whose ring fits a block's shared memory and whose blocks
fit an SM together. ``--baseline DIR``
adds another tree's ``csrc/`` (with its own headers), timed first and
last.

The inputs:

* (a) DLRM's shape: Adagrad, 4Mi rows, ch = 1, N = 106,496 unique
  indices with a few sentinels, negatives and past-the-end indices
  (:func:`fused_inputs`);
* (b) the table step's shape: Adam, 2Mi rows, ch = 2, N = 65,536;
* (c) the main path's own operands: ``idx``, ``packed`` and ``grads`` as
  one full-width DLRM training step hands them to the kernel
  (:func:`main_path_inputs`), where about two thirds of the rows belong
  to the trash row; their share is printed.

Each version is first held against the plain version at every input
(:func:`compare`: rows it must not write bit-exact, written f32 words
within 4 ulps, bf16 halves within 1), then timed as ``dma_bench`` times a
call (``dma_bench.call_ms``: 20 back-to-back calls, CUDA events behind a
device spin). Prints one line per version and last one JSON object with
every time, the bytes bounds and the card's name and power limit; the
geometry to keep is the one with the lowest sum over (a)-(c).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import itertools
import json
import re
import shutil
from pathlib import Path

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.ops import optimizer as opt_lib
from recommenders_addons_tpu_torch.tools import dma_bench, gather_sweep
from recommenders_addons_tpu_torch.utils.config import resolve_device

STAGE_KIB = (16, 32, 64)
STAGES = (2, 4)
BLOCKS = (1, 2, 3)
CONSUMERS = (4, 8)
CONSTS = ("kStageBytes", "kStages", "kBlocksPerSm", "kConsumers")
_SM_KIB = 227  # shared memory of one block, and (about) of one SM
_BUILD_AT_ONCE = 8
_SWEEP_DIR = cuda_ops._BUILD_DIR.parent / "fused_sweep"
_LANES = 128
DIM = 64  # DLRMConfig.dim, bench.py's table-step dim
STEP = 4.0


def default_geometries() -> list:
    """(KiB, stages, blocks, consumers) whose ring fits a block and whose
    blocks fit an SM together (a larger cap would change nothing)."""
    return [g for g in itertools.product(STAGE_KIB, STAGES, BLOCKS,
                                         CONSUMERS)
            if g[0] * g[1] * g[2] < _SM_KIB]


def copy_kernel(name: str, src: Path, consts: dict) -> cuda_ops._Kernel:
    """The fused kernel of ``src`` copied to ``build/fused_sweep/name``
    with ``consts`` rewritten (each found once), as a kernel that builds
    from there."""
    dest = _SWEEP_DIR / name
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    for header in src.glob("*.cuh"):
        shutil.copy(header, dest)
    k = cuda_ops.FUSED_UPDATE_SCATTER
    text = (src / f"{k.name}.cu").read_text()
    for const, value in consts.items():
        text, hits = re.subn(rf"constexpr int {const} = [^;]*;",
                             f"constexpr int {const} = {value};", text)
        if hits != 1:
            raise RuntimeError(f"{k.name}.cu: no single {const}")
    (dest / f"{k.name}.cu").write_text(text)
    copy = cuda_ops._Kernel(k.name, k.argtypes)
    copy.source = dest / f"{k.name}.cu"
    return copy


# ---------------------------------------------------------------------------
# the inputs, and the check against the plain version
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Inputs:
    """One call's operands: the physical table, its chunks and logical
    capacity, the batch and the rule."""

    table: torch.Tensor
    ch: int
    cap: int
    idx: torch.Tensor
    packed: torch.Tensor
    grads: torch.Tensor
    rule: cuda_ops.FusedRule
    dim: int
    names: tuple
    pf: int = 1
    step: float = STEP

    @classmethod
    def of_call(cls, a: dict) -> "Inputs":
        """The inputs of one recorded ``fused_update_scatter`` call
        (:func:`record_calls`)."""
        return cls(a["table2d"], a["ch"], a["cap"], a["idx"], a["packed"],
                   a["grads"], a["rule"], a["dim"], tuple(a["slot_names"]),
                   a["pf"], float(a["step"]))

    def call(self, table=None, kernel=None) -> None:
        """``cuda_ops.fused_update_scatter`` on ``table`` (default the
        inputs' own), in place; with ``kernel``, that build of the kernel
        instead (a CUDA table only)."""
        table = self.table if table is None else table
        if kernel is None:
            cuda_ops.fused_update_scatter(
                table, self.ch, self.idx, self.packed, self.grads,
                self.rule, dim=self.dim, slot_names=self.names,
                cap=self.cap, step=self.step, pf=self.pf)
            return
        t32, idx, pk, g = cuda_ops._fused_args(
            table, self.ch, self.idx, self.packed, self.grads, self.rule,
            self.dim, self.names, self.cap, self.pf)
        cuda_ops._fused_cuda(t32, self.ch, self.cap, idx, pk, g, self.rule,
                             self.dim, self.names, self.step, self.pf,
                             kernel=kernel)

    def plain(self, table) -> None:
        cuda_ops.fused_update_scatter_plain(
            table, self.ch, self.idx, self.packed, self.grads, self.rule,
            dim=self.dim, slot_names=self.names, cap=self.cap,
            step=self.step, pf=self.pf)

    def valid(self) -> torch.Tensor:
        return (self.idx >= 0) & (self.idx < self.cap)

    def trash_share(self) -> float:
        return 1.0 - int(self.valid().sum()) / self.idx.shape[0]

    def used_words(self) -> int:
        """32-bit words of a row's value and slot columns (the rest of the
        row is zero padding)."""
        return self.dim // self.pf * (1 + len(self.names))

    def bound_bytes(self) -> int:
        """Bytes the call must move: for each row with a valid index its
        value and slot words read, its grad row read and the whole table
        row written (ch*512 B); plus 4 B of index per row. Rows bound for
        the trash row and padding words need not move."""
        rows = int(self.valid().sum())
        return (rows * (4 * self.used_words() + self.dim * 4
                        + self.ch * _LANES * 4) + 4 * self.idx.shape[0])

    def moved_bytes(self) -> int:
        """Bytes the kernel moves: :meth:`bound_bytes` with each row's
        read of value and slot words rounded up to 16 B."""
        rows = int(self.valid().sum())
        extra = -(-self.used_words() // 4) * 16 - 4 * self.used_words()
        return self.bound_bytes() + rows * extra


def fused_inputs(dev, gen, rule, pf, cap, n, dim=DIM, foreign=True,
                 step=STEP) -> Inputs:
    """Table, packed rows, grads and indices for a check of ``rule``:
    values uniform in [0.05, 1) (positive accumulators), optionally a
    foreign slot column ("zz") the kernel must pass through; indices
    unique slots with every 97th the sentinel, and some negative or past
    the end."""
    names = tuple(sorted(set(rule.slots) | ({"zz"} if foreign else set())))
    vdt = torch.float32 if pf == 1 else torch.bfloat16
    w = -(-dim * (1 + len(names)) // (_LANES * pf)) * _LANES * pf
    ch = w // (_LANES * pf)
    wc = ch * _LANES

    def rows(k):
        x = torch.rand((k, w), device=dev, generator=gen) * 0.95 + 0.05
        return x.to(vdt).view(torch.float32).reshape(k, wc)

    table = rows(cap + 1).reshape((cap + 1) * ch, _LANES)
    packed = rows(n)
    grads = torch.randn((n, dim), device=dev, generator=gen)
    idx = torch.randperm(cap, device=dev, generator=gen)[:n].to(torch.int32)
    idx[::97] = cap
    idx[5::211] = -1
    idx[7::223] = cap + 5
    return Inputs(table, ch, cap, idx, packed, grads, rule, dim, names, pf,
                  step)


def record_calls(run, name: str = "fused_update_scatter",
                 limit: int | None = None) -> list:
    """Runs ``run()`` and returns the operands of the first ``limit``
    (default every) calls it makes of ``cuda_ops.<name>``: each call's
    arguments by name, defaults filled in, its tensors copied before the
    call's own launch. :meth:`Inputs.of_call` reads a fused apply's."""
    seen = []
    real = getattr(cuda_ops, name)
    sig = inspect.signature(real)

    def record(*args, **kw):
        if limit is None or len(seen) < limit:
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            seen.append({k: v.clone() if torch.is_tensor(v) else v
                         for k, v in bound.arguments.items()})
        return real(*args, **kw)

    setattr(cuda_ops, name, record)
    try:
        run()
    finally:
        setattr(cuda_ops, name, real)
    return seen


def main_path_inputs(dev, seed: int = 0, cfg=None, batch: int = 4096
                     ) -> Inputs:
    """The kernel's operands as one DLRM training step hands them to it:
    a fresh model (``cfg``, default the full-width ``DLRMConfig()``) with
    its Adagrad slots created, one step on ``synthetic_criteo_batch`` at
    ``seed``; the call's table, index, packed rows and grads are copied
    before the step's own launch."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.models import dlrm

    model = dlrm.DLRM(cfg or dlrm.DLRMConfig(), device=dev)
    state = model.init(seed)
    state = dataclasses.replace(
        state, table=de.create_slots(model.var, state.table, model.opt))
    train_step, tx = model.make_train_step()
    opt_state = tx.init(list(state.dense.parameters()))
    b = dlrm.synthetic_criteo_batch(np.random.default_rng(seed), batch)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    seen = record_calls(lambda: train_step(state, opt_state, b))
    if len(seen) != 1:
        raise AssertionError(f"one DLRM step called the fused apply "
                             f"{len(seen)} times")
    return Inputs.of_call(seen[0])


def max_ulps(a: torch.Tensor, b: torch.Tensor, bits: int) -> int:
    """Max distance in ulps between two float tensors (f32 or bf16 bit
    patterns ordered across the sign)."""
    it, mag = ((torch.int32, 0x7FFFFFFF) if bits == 32
               else (torch.int16, 0x7FFF))

    def ordered(t):
        i = t.contiguous().view(it).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def compare(got: torch.Tensor, want: torch.Tensor, inp: Inputs, what: str):
    """Rows [0, cap) of two results of ``inp``: rows it must not write
    bit-exact, written f32 words within 4 ulps and bf16 halves within 1
    (0 expected). Returns (ulps, max |difference| as floats); raises on a
    mismatch."""
    cap, wc = inp.cap, inp.ch * _LANES
    ra = got[:cap * inp.ch].view(cap, wc)
    rb = want[:cap * inp.ch].view(cap, wc)
    written = torch.zeros(cap, dtype=torch.bool, device=got.device)
    written[inp.idx[inp.valid()].long()] = True
    if not torch.equal(ra[~written].view(torch.int32),
                       rb[~written].view(torch.int32)):
        raise AssertionError(f"{what}: rows it must not write differ")
    wa, wb = ra[written], rb[written]
    if inp.pf == 1:
        ulps = max_ulps(wa, wb, 32)
        err = float((wa - wb).abs().max()) if wa.numel() else 0.0
    else:
        ha, hb = wa.view(torch.bfloat16), wb.view(torch.bfloat16)
        ulps = max_ulps(ha, hb, 16)
        err = (float((ha.float() - hb.float()).abs().max())
               if ha.numel() else 0.0)
    if ulps > (4 if inp.pf == 1 else 1):
        raise AssertionError(f"{what}: {ulps} ulps off the plain version")
    return ulps, err


def sweep_inputs(dev, seed: int = 0) -> dict:
    """The three inputs (a), (b), (c), made on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "a": fused_inputs(dev, gen, opt_lib.Adagrad(0.01).fused_rule(), 1,
                          1 << 22, 4096 * 26, foreign=False),
        "b": fused_inputs(dev, gen, opt_lib.Adam(0.001).fused_rule(), 1,
                          1 << 21, 65536, foreign=False),
        "c": main_path_inputs(dev, seed),
    }


def main(argv=None, *, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path, default=None,
                   help="another tree's csrc/ directory, timed first and "
                        "last")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("geometries", nargs="*",
                   help="KIB,STAGES,BLOCKS,CONSUMERS (default: the full "
                        "grid)")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the sweep times CUDA kernels: it needs a card")
    geoms = ([tuple(int(x) for x in g.split(",")) for g in args.geometries]
             or default_geometries())
    src = cuda_ops._PKG / "csrc"
    versions = {}
    if args.baseline is not None:
        versions["baseline"] = copy_kernel("baseline", args.baseline, {})
    for kib, stages, blocks, consumers in geoms:
        versions[f"{kib}KiB x{stages} x{blocks}/SM c{consumers}"] = (
            copy_kernel(f"{kib}k_{stages}s_{blocks}b_{consumers}c", src,
                        dict(zip(CONSTS, (f"{kib} * 1024", stages, blocks,
                                          consumers)))))
    if args.baseline is not None:
        versions["baseline again"] = versions["baseline"]
    todo = list({id(k): k for k in versions.values()}.values())
    for i in range(0, len(todo), _BUILD_AT_ONCE):
        cuda_ops.build_kernels(todo[i:i + _BUILD_AT_ONCE])
    card = gather_sweep._card()
    print(card, flush=True)
    rate = dma_bench.mem_rate(torch.cuda.get_device_name(0))
    inputs = sweep_inputs(dev, args.seed)
    wants = {}
    for key, inp in inputs.items():
        want = inp.table.clone()
        inp.plain(want)
        wants[key] = want
    result = {"card": card, "inputs": {}, "versions": {}}
    for key, inp in inputs.items():
        result["inputs"][key] = {
            "rule": inp.rule.kind, "cap": inp.cap, "ch": inp.ch,
            "n": inp.idx.shape[0], "trash_share": inp.trash_share(),
            "bound_ms": inp.bound_bytes() / rate * 1e3,
            "moved_bytes": inp.moved_bytes()}
    print("inputs: " + json.dumps(result["inputs"]), flush=True)
    for version, kernel in versions.items():
        row = {}
        for key, inp in inputs.items():
            got = inp.table.clone()
            inp.call(got, kernel)
            torch.cuda.synchronize()
            compare(got, wants[key], inp, f"{version} ({key})")
            row[key] = dma_bench.call_ms(lambda: inp.call(got, kernel), dev)
            del got
        row["sum"] = sum(row.values())
        result["versions"][version] = row
        print(f"{version:>26}: " + "  ".join(
            f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    swept = {v: r for v, r in result["versions"].items()
             if not v.startswith("baseline")}
    if swept:
        result["best"] = min(swept, key=lambda v: swept[v]["sum"])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
