"""Data loading for recommender training — the port of the JAX package's
``data/loader.py``.

* :class:`CriteoTSVReader` — chunked reader for Criteo-format TSV (label,
  13 numeric, 26 categorical), hashing the categorical tokens through the
  native batch hasher (``ops/hashing.hash_strings``) and log-normalizing
  the numeric features. Its batches are the JAX reader's, bit for bit.
* :class:`MovieLensRatingsReader` — MovieLens ratings (``::`` or
  tab-separated), shuffled in a buffer with the JAX reader's order.
* :class:`Prefetcher` — a background thread that prepares the next
  batches and places them on the device while the card trains. The
  default placement copies each batch from pinned host memory on a side
  stream; the consumer's stream waits for that copy (an event) when it
  takes the batch.

Readers yield numpy dicts; placement makes them tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashing
from recommenders_addons_tpu_torch.utils.config import resolve_device


class CriteoTSVReader:
    """Chunked Criteo TSV -> training batches.

    Yields dicts: ``dense [B, 13] float32`` (log1p-normalized, missing=0),
    ``sparse [B, 26] int64`` (feature-tagged fingerprints; missing gets a
    per-column sentinel token so it stays a valid, learnable id),
    ``label [B] float32``.
    """

    NUM_DENSE = 13
    NUM_SPARSE = 26

    def __init__(self, path: str, batch_size: int = 4096,
                 repeat: bool = False):
        self.path = path
        self.batch_size = batch_size
        self.repeat = repeat

    def __iter__(self) -> Iterator[dict]:
        while True:
            with open(self.path, "r") as f:
                rows = []
                for line in f:
                    rows.append(line.rstrip("\n").split("\t"))
                    if len(rows) == self.batch_size:
                        yield self._make_batch(rows)
                        rows = []
                if rows:
                    yield self._make_batch(rows)
            if not self.repeat:
                return

    def _make_batch(self, rows) -> dict:
        n = len(rows)
        label = np.zeros((n,), np.float32)
        dense = np.zeros((n, self.NUM_DENSE), np.float32)
        cat_tokens = []
        for i, r in enumerate(rows):
            label[i] = float(r[0] or 0)
            for j in range(self.NUM_DENSE):
                v = r[1 + j]
                dense[i, j] = np.log1p(max(float(v), 0.0)) if v else 0.0
            for j in range(self.NUM_SPARSE):
                tok = r[1 + self.NUM_DENSE + j] if len(r) > 14 + j else ""
                cat_tokens.append(f"{j}:{tok or '<missing>'}")
        sparse = hashing.hash_strings(cat_tokens).reshape(
            n, self.NUM_SPARSE)
        return {"dense": dense, "sparse": sparse, "label": label}


class MovieLensRatingsReader:
    """MovieLens ratings file -> training batches.

    Auto-detects the two public formats by delimiter:

      * ml-1m/ml-10m ``ratings.dat``: ``UserID::MovieID::Rating::Timestamp``
      * ml-100k ``u.data``: tab-separated ``user item rating timestamp``

    Yields dicts ``{"user" [B] int64, "movie" [B] int64,
    "rating" [B] float32}``; shuffles within a buffer of
    ``shuffle_buffer`` rows (numpy's ``default_rng(seed)``, so a seed
    gives the JAX reader's order).
    """

    def __init__(self, path: str, batch_size: int = 256,
                 repeat: bool = False, shuffle_buffer: int = 100_000,
                 seed: int = 0):
        self.path = path
        self.batch_size = batch_size
        self.repeat = repeat
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed

    def _parse(self, line: str):
        line = line.strip()
        if not line:
            return None
        parts = line.split("::") if "::" in line else line.split()
        if len(parts) < 3:
            return None
        return int(parts[0]), int(parts[1]), float(parts[2])

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            buf = []
            with open(self.path, "r") as f:
                for line in f:
                    rec = self._parse(line)
                    if rec is None:
                        continue
                    buf.append(rec)
                    if len(buf) >= self.shuffle_buffer:
                        yield from self._drain(buf, rng)
                        buf = []
            yield from self._drain(buf, rng, final=True)
            if not self.repeat:
                return

    def _drain(self, buf, rng, final: bool = False):
        idx = rng.permutation(len(buf))
        for s in range(0, len(buf), self.batch_size):
            take = idx[s:s + self.batch_size]
            if len(take) < self.batch_size and not final:
                break
            rows = [buf[i] for i in take]
            yield {
                "user": np.asarray([r[0] for r in rows], np.int64),
                "movie": np.asarray([r[1] for r in rows], np.int64),
                "rating": np.asarray([r[2] for r in rows], np.float32),
            }


def _tree_map(fn, batch):
    """``fn`` on every array leaf of a dict / list / tuple batch."""
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


class _InFlight:
    """A batch whose host-to-device copies were queued on a side stream,
    with the event recorded after them."""

    def __init__(self, batch, event: torch.cuda.Event, device):
        self.batch, self.event, self.device = batch, event, device

    def ready(self):
        """The batch, once the current stream waits for its copies; each
        tensor is marked as used on that stream, so the caching allocator
        keeps its memory until the stream's work on it is done."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        _tree_map(lambda t: t.record_stream(stream)
                  if isinstance(t, torch.Tensor) else t, self.batch)
        return self.batch


class DevicePlacement:
    """The default placement: numpy leaves (and tensors) to ``device``.
    On a card, from pinned host memory by non-blocking copies on a side
    stream, run on the prefetch thread; :class:`Prefetcher` has the
    consumer's stream wait for them. On the CPU, tensors sharing the
    arrays' memory."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, batch):
        if self._stream is None:
            return _tree_map(lambda a: torch.as_tensor(a, device=self.device),
                             batch)

        def copy(a):
            t = torch.as_tensor(a)
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = _tree_map(copy, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _InFlight(out, event, self.device)


class Prefetcher:
    """Background batch preparation and device placement.

    ``source`` is any iterator of batch dicts (numpy). The worker thread
    stays ``depth`` batches ahead; ``placement`` (default
    :class:`DevicePlacement` on ``device``, CUDA unless told otherwise)
    runs on the worker, so the training loop only dequeues batches that
    are on the device or on their way there. An error of the worker is
    raised at the next dequeue."""

    _DONE = object()

    def __init__(self, source, depth: int = 2,
                 placement: Optional[Callable] = None, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._placement = placement or DevicePlacement(device)
        self._err = None
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for batch in it:
                self._q.put(self._placement(batch))
        except Exception as e:  # surfaced on the next dequeue
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)  # later calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item.ready() if isinstance(item, _InFlight) else item


def prefetch(source, depth: int = 2, placement=None,
             device=None) -> Prefetcher:
    """tf.data-style ``.prefetch()`` over any batch iterator; batches land
    on ``device`` (default CUDA) unless a ``placement`` is given."""
    return Prefetcher(source, depth=depth, placement=placement,
                      device=device)
