"""Fused-apply cost probe: what do the parts of a fused optimizer-scatter
kernel cost on the card (the Adam math, the pass over the staged tile,
the stores), and how do its two knobs, the sub-chunk that interleaves
compute with store issue and the number of stores in flight, move it?
The port's counterpart of the JAX package's ``tools/ab_kernel_cost.py``,
on an NVIDIA Hopper card.

    python -m recommenders_addons_tpu_torch.tools.ab_kernel_cost

For each variant of :data:`VARIANTS` it prints ns/row, the slope between
batches of 8,192 and 65,536 rows, and the ms of one call at each batch:
each batch is timed as the best of 3 runs of 10 calls (CUDA events behind
a device spin, ``dma_bench.seconds``), whose indices rotate by a
multiplicative step, as the JAX tool's scan does.

:func:`make_fused` ``(mode, sub, nbuf)`` returns ``fn(table2d, idx,
packed, g, step)``, which writes the physical ``[(CAP+1)*2, 128]`` f32
table in place and returns it: the row at ``idx[j]`` (premultiplied by 2
in int32, as the reference does) becomes

* ``adam``: :func:`adam_tile` of ``packed[j]`` (``[value | m | v | pad]``,
  256 words) and ``g[j]`` (64): new value, m, v, then zeros;
* ``identity`` and ``rawcopy``: ``packed[j]`` unchanged (the kernel passes
  over the staged words, or stores them as they came in).

A CUDA tensor launches ``csrc/ab_fused.cu`` or raises; a CPU tensor runs
:func:`ab_fused_plain`. Each callable carries both, as ``.plain`` and
``.kernel``.

Where the reference is undefined or differs: any N runs (it drops the
rows past its last 1,024-row tile); a row whose start falls outside the
table is skipped, so the sentinel index ``CAP`` writes the trash row;
duplicate indices race on the card. The tool's random indices hold
about 1,000 duplicate pairs per 65,536 rows, which is harmless for
timing; a check must use unique indices.
"""

from __future__ import annotations

import functools

import torch

from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.tools import dma_bench
from recommenders_addons_tpu_torch.utils.config import resolve_device

CAP = 1 << 21
D = 64
W = 256
CH = 2
_LANES = 128
_NBUF = 32
BATCHES = (1 << 13, 1 << 16)
STEPS = 10

# the kernel's mode argument (csrc/ab_fused.cu), and the knobs it takes
MODES = {"adam": 0, "identity": 1, "rawcopy": 2}
SUBS = (64, 128, 1024)
NBUFS = (32, 64)

# the JAX tool's main() list (tools/ab_kernel_cost.py:175-181)
VARIANTS = [
    ("adam chunk128", dict(mode="adam", sub=128)),
    ("adam chunk64", dict(mode="adam", sub=64)),
    ("adam chunk128 nbuf64", dict(mode="adam", sub=128, nbuf=64)),
    ("adam chunk64 nbuf64", dict(mode="adam", sub=64, nbuf=64)),
    ("ident chunk128", dict(mode="identity", sub=128)),
]


def adam_tile(packed: torch.Tensor, g: torch.Tensor, step) -> torch.Tensor:
    """The plain tile math: ``[N, 256]`` packed rows and ``[N, 64]`` grads
    -> the new ``[N, 256]`` rows (the JAX tool's ``adam_tile``)."""
    rows = packed[:, :D]
    m = packed[:, D:2 * D]
    v = packed[:, 2 * D:3 * D]
    t = torch.full((1, 1), float(step), dtype=rows.dtype,
                   device=rows.device) + 1.0
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    lr = 0.001 * torch.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t)
    new = rows - lr * m / (torch.sqrt(v) + 1e-7)
    return torch.cat([new, m, v, new.new_zeros((new.shape[0], W - 3 * D))],
                     dim=1)


def _args(table2d, idx, packed, g):
    """(table words, int32 index, packed, g) after the checks."""
    t32 = dma_bench._table_words(table2d, CH)
    idx = cuda_ops._index(idx, t32.device)
    n = idx.shape[0]
    for what, t, width in (("packed", packed, W), ("g", g, D)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, width):
            raise ValueError(f"{what} must be [{n}, {width}] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != t32.device:
            raise ValueError(f"{what} on {t.device}, table on {t32.device}")
    return t32, idx, packed.contiguous(), g.contiguous()


def ab_fused_plain(table2d: torch.Tensor, idx: torch.Tensor,
                   packed: torch.Tensor, g: torch.Tensor, step, *,
                   mode: str) -> torch.Tensor:
    """The plain PyTorch version of :func:`make_fused`'s callables, on any
    device: :func:`adam_tile` (``adam``) or the packed rows unchanged,
    then an indexed store; in place, returns ``table2d``."""
    _, idx, packed, g = _args(table2d, idx, packed, g)
    new = adam_tile(packed, g, step) if mode == "adam" else packed
    return dma_bench.scatter_plain(table2d, idx, new, ch=CH)


def make_fused(mode: str, sub: int = 1024, nbuf: int = _NBUF):
    """The fused apply of ``mode`` (a key of :data:`MODES`), computing
    and issuing stores per ``sub`` rows (one of :data:`SUBS`) with
    ``nbuf`` stores in flight (one of :data:`NBUFS`); the JAX tool's
    ``make_fused``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    dma_bench._check_pow2("sub", sub, SUBS)
    dma_bench._check_pow2("nbuf", nbuf, NBUFS)
    plain = functools.partial(ab_fused_plain, mode=mode)

    def fused(table2d, idx, packed, g, step):
        t32, idx, packed, g = _args(table2d, idx, packed, g)
        if not cuda_ops._is_cuda(t32):
            return plain(table2d, idx, packed, g, step)
        cuda_ops._check_aligned(t32, packed, g)
        n = idx.shape[0]
        if n:
            cuda_ops.AB_FUSED.launch(
                t32.device, t32.data_ptr(), t32.shape[0], idx.data_ptr(), n,
                packed.data_ptr(), g.data_ptr(), float(step), MODES[mode],
                sub, nbuf)
        return table2d

    return dma_bench._with(fused, plain, cuda_ops.AB_FUSED)


def row_bytes(mode: str) -> int:
    """Bytes one row must move: its packed row and index read, g read
    (``adam``), the new row written."""
    return 2 * W * 4 + 4 + (D * 4 if mode == "adam" else 0)


def timed(fn, table, idx, packed, g) -> float:
    """Seconds per call of ``fn``: STEPS calls on indices rotated by a
    multiplicative step (call ``i`` passes ``step=i``), best of 3 runs
    after one warm-up run."""
    k = 2654435761 % CAP
    base = idx.to(torch.int64)
    steps = [((base + i * k) & (CAP - 1)).to(torch.int32)
             for i in range(STEPS)]

    def run():
        for i, ix in enumerate(steps):
            fn(table, ix, packed, g, i)

    run()
    return min(dma_bench.seconds(run, table.device, STEPS)
               for _ in range(3)) / STEPS


def main(device=None) -> dict:
    """Run every variant of :data:`VARIANTS` on ``device`` (default CUDA;
    raises without a card unless given ``device="cpu"``). Prints one line
    per variant and returns the numbers."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rate = dma_bench.mem_rate(kind) if dev.type == "cuda" else None
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(((CAP + 1) * CH, _LANES), generator=gen, device=dev)
    print(f"cap={CAP} device={kind}", flush=True)
    b0, b1 = BATCHES
    out = {"device": kind, "cap": CAP, "batches": list(BATCHES),
           "steps": STEPS, "mem_bytes_per_s": rate, "variants": {}}
    for name, kw in VARIANTS:
        fn = make_fused(**kw)
        ts = {}
        for b in BATCHES:
            idx = torch.randint(0, CAP, (b,), dtype=torch.int32,
                                generator=gen, device=dev)
            packed = torch.randn((b, W), generator=gen, device=dev)
            g = torch.randn((b, D), generator=gen, device=dev) * 0.01
            ts[b] = timed(fn, table, idx, packed, g)
        s = (ts[b1] - ts[b0]) / (b1 - b0)
        bound = (None if rate is None
                 else row_bytes(kw["mode"]) / rate * 1e9)
        out["variants"][name] = {
            "ns_per_row": s * 1e9, "ms": {str(b): ts[b] * 1e3
                                          for b in BATCHES},
            "bound_ns_per_row": bound}
        print(f"{name:>20}: {s * 1e9:6.3f} ns/row  "
              f"[{ts[b0] * 1e3:7.4f} ms, {ts[b1] * 1e3:7.4f} ms]  (bound "
              f"{'not measured' if bound is None else f'{bound:.3f} ns/row'})",
              flush=True)
    return out


if __name__ == "__main__":
    main()
