"""Ring-geometry sweep of the two pipelined bulk-copy gathers on an NVIDIA
card: ``dma_gather`` (``csrc/dma_gather.cu``) and ``dma_gather_grouped``
(``csrc/dma_gather_grouped.cu``), the row-copy micro-benchmark's gathers.

    python -m recommenders_addons_tpu_torch.tools.gather_sweep \\
        [--baseline DIR] [KIB,STAGES,BLOCKS ...]

A geometry is a stage size in KiB, the stages in the ring and the cap on
resident blocks per SM: the three constants (``kStageBytes``,
``kStages``, ``kBlocksPerSm``) of both sources. Each is a copy of
``csrc/`` under ``build/gather_sweep/`` with those constants rewritten;
the copies are built with the package's nvcc flags, a few at a time. The
default list is every combination of 16/32/64 KiB stages, 2/3/4/6/8
stages and 1-3 blocks per SM whose ring fits a block's shared memory and
whose blocks fit an SM together. ``--baseline DIR`` adds the two sources
of another tree's ``csrc/`` (with its own headers), timed first and last.

At the micro-benchmark's two shapes (2Mi x 1 KiB and 4Mi x 512 B rows,
uniform random indices, N = 65,536), each copy's kernels run every
gather variant of ``dma_bench.VARIANTS``: first held bit-exact against
the plain version, then timed as the tool times a call
(``dma_bench.call_ms``: 20 back-to-back calls, CUDA events behind a
device spin), beside ``torch.index_select`` and kernel 1
(``cuda_ops.gather_rows_2d``) on the same inputs. Prints one line per
geometry and shape, and last one JSON object with every time and the
card's name.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.tools import dma_bench
from recommenders_addons_tpu_torch.utils.config import resolve_device

STAGE_KIB = (16, 32, 64)
STAGES = (2, 3, 4, 6, 8)
BLOCKS = (1, 2, 3)
SHAPES = ((21, 2), (22, 1))  # dma_bench's default and kernel 1's shape
_SM_KIB = 227  # shared memory of one block, and (about) of one SM
_BUILD_AT_ONCE = 8
_SWEEP_DIR = cuda_ops._BUILD_DIR.parent / "gather_sweep"
_KERNELS = (cuda_ops.DMA_GATHER, cuda_ops.DMA_GATHER_GROUPED)


def default_geometries() -> list:
    """(KiB, stages, blocks) whose ring fits a block and whose blocks fit
    an SM together (a larger cap would change nothing)."""
    return [(kib, s, b) for kib in STAGE_KIB for s in STAGES for b in BLOCKS
            if kib * s * b < _SM_KIB]


def _copy(name: str, src: Path, consts: dict) -> dict:
    """The two gathers of ``src`` copied to ``build/gather_sweep/name``
    with ``consts`` rewritten, as kernels that build from there."""
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


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _run_shape(versions: dict, log2cap: int, ch: int, dev) -> dict:
    """ms of every gather variant of every version at one shape."""
    cap = 1 << log2cap
    n = dma_bench.BATCHES[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-(1 << 31), (1 << 31) - 1, (cap * ch, 128),
                          dtype=torch.int32, device=dev,
                          generator=gen).view(torch.float32)
    idx = torch.randint(0, cap, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    logical = table.view(cap, ch * 128)
    out = {"torch.index_select": dma_bench.call_ms(
        lambda: torch.index_select(logical, 0, idx), dev),
        "row_gather (kernel 1)": dma_bench.call_ms(
        lambda: cuda_ops.gather_rows_2d(table, ch, idx, masked=False), dev)}
    print(f"cap={cap} ch={ch}: " + "  ".join(
        f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    for version, kernels in versions.items():
        row = {}
        for variant, kw in dma_bench.VARIANTS:
            fn = dma_bench.make_variant(kw, ch=ch, scatter=False)
            fn.kernel = kernels[fn.kernel.name]
            got = fn(table, idx).view(torch.int32)
            if not torch.equal(got, fn.plain(table, idx).view(torch.int32)):
                raise AssertionError(f"{version} {variant} disagrees with "
                                     f"its plain version at ch={ch}")
            row[variant] = dma_bench.call_ms(lambda: fn(table, idx), dev)
        out[version] = row
        print(f"{version:>20} cap={cap} ch={ch}: " + "  ".join(
            f"{' '.join(v.split())} {ms:.4f}" for v, ms in row.items()),
            flush=True)
    return out


def main(argv=None, *, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path, default=None,
                   help="another tree's csrc/ directory, timed first and "
                        "last")
    p.add_argument("geometries", nargs="*",
                   help="KIB,STAGES,BLOCKS (default: the full grid)")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the sweep times CUDA kernels: it needs a card")
    geoms = ([tuple(int(x) for x in g.split(",")) for g in args.geometries]
             or default_geometries())
    src = cuda_ops._PKG / "csrc"
    versions = {}
    if args.baseline is not None:
        versions["baseline"] = _copy("baseline", args.baseline, {})
    for kib, stages, blocks in geoms:
        versions[f"{kib}KiB x{stages} x{blocks}/SM"] = _copy(
            f"{kib}k_{stages}s_{blocks}b", src,
            {"kStageBytes": f"{kib} * 1024", "kStages": stages,
             "kBlocksPerSm": blocks})
    if args.baseline is not None:
        versions["baseline again"] = versions["baseline"]
    todo = list({id(k): k for ks in versions.values()
                 for k in ks.values()}.values())
    for i in range(0, len(todo), _BUILD_AT_ONCE):
        cuda_ops.build_kernels(todo[i:i + _BUILD_AT_ONCE])
    card = _card()
    print(card, flush=True)
    result = {"card": card, "n": dma_bench.BATCHES[1], "shapes": {}}
    for log2cap, ch in SHAPES:
        result["shapes"][f"cap={1 << log2cap} ch={ch}"] = _run_shape(
            versions, log2cap, ch, dev)
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
