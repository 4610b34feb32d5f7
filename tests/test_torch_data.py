"""The port's input pipeline (``data/``) and profiling helpers
(``utils/profiling.py``) against the JAX package's: the Criteo reader's
batches bit-equal to the JAX reader's on the same file (its sparse ids
come from the port's own string hasher), repeat and prefetch, errors
surfacing at the next dequeue, both MovieLens formats with the JAX
reader's shuffle order, and the profiling helpers on the CPU. Files are
fabricated as ``tests/test_data.py`` makes them."""

import os

import numpy as np
import pytest
import torch

from recommenders_addons_tpu.data import (
    CriteoTSVReader as JCriteoTSVReader,
    MovieLensRatingsReader as JMovieLensRatingsReader,
)
from recommenders_addons_tpu_torch.data import (
    CriteoTSVReader,
    MovieLensRatingsReader,
    Prefetcher,
    prefetch,
)
from recommenders_addons_tpu_torch.utils import profiling


def write_criteo(path, n=10):
    """Criteo-format lines with a missing dense column (3) and a missing
    categorical one (5)."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(n):
            dense = [str(rng.integers(0, 100)) if j != 3 else ""
                     for j in range(13)]
            cats = [f"{rng.integers(0, 0xffff):x}" if j != 5 else ""
                    for j in range(26)]
            f.write("\t".join([str(i % 2)] + dense + cats) + "\n")


def write_movielens(path, n=3000, fmt="dat"):
    """Ratings with a latent structure (user x movie parity)."""
    rng = np.random.default_rng(2)
    sep = "::" if fmt == "dat" else "\t"
    with open(path, "w") as f:
        for _ in range(n):
            u = int(rng.integers(1, 200))
            m = int(rng.integers(1, 300))
            r = 4.0 if (u + m) % 2 == 0 else 2.0
            f.write(sep.join([str(u), str(m), str(r), "978300760"]) + "\n")


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_criteo_reader_matches_jax(tmp_path):
    p = str(tmp_path / "day.tsv")
    write_criteo(p, 10)
    batches = list(CriteoTSVReader(p, batch_size=4))
    assert [len(b["label"]) for b in batches] == [4, 4, 2]
    b = batches[0]
    assert b["dense"].shape == (4, 13) and b["dense"].dtype == np.float32
    assert b["sparse"].shape == (4, 26) and b["sparse"].dtype == np.int64
    # missing dense column -> 0; missing cat -> one stable sentinel token
    assert (b["dense"][:, 3] == 0).all()
    assert len(set(b["sparse"][:, 5].tolist())) == 1
    assert b["sparse"][0, 0] != b["sparse"][0, 1]
    _same_batches(batches, list(JCriteoTSVReader(p, batch_size=4)))


def test_reader_repeat_and_prefetch(tmp_path):
    p = str(tmp_path / "day.tsv")
    write_criteo(p, 8)
    src = CriteoTSVReader(p, batch_size=8, repeat=True)
    it = prefetch(src, depth=2, device="cpu")
    seen = [next(it) for _ in range(3)]  # repeats past one epoch
    assert all(s["label"].shape == (8,) for s in seen)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for s in seen for v in s.values())
    want = next(iter(CriteoTSVReader(p, batch_size=8)))
    for s in seen:
        for k in want:
            np.testing.assert_array_equal(s[k].numpy(), want[k])


def test_prefetch_placement_and_default_device():
    seen = list(Prefetcher(iter([{"x": np.arange(3)}] * 2), depth=1,
                           placement=lambda b: {"x": b["x"] * 2}))
    assert [list(s["x"]) for s in seen] == [[0, 2, 4]] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prefetch(iter([]))  # the default device is the card


def test_prefetch_propagates_errors():
    def bad_source():
        yield {"x": np.zeros(2)}
        raise RuntimeError("boom")

    it = prefetch(bad_source(), depth=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in it:
            pass


@pytest.mark.parametrize("fmt", ["dat", "tsv"])
def test_movielens_reader_both_formats(tmp_path, fmt):
    p = str(tmp_path / f"ratings.{fmt}")
    write_movielens(p, n=1000, fmt=fmt)
    batches = list(MovieLensRatingsReader(p, batch_size=256))
    assert sum(b["user"].shape[0] for b in batches) == 1000
    b = batches[0]
    assert b["user"].dtype == np.int64 and b["rating"].dtype == np.float32
    assert set(np.unique(b["rating"])) <= {2.0, 4.0}
    _same_batches(batches, list(JMovieLensRatingsReader(p, batch_size=256)))


def test_movielens_reader_shuffles_and_repeats(tmp_path):
    p = str(tmp_path / "ratings.dat")
    write_movielens(p, n=768)
    it = iter(MovieLensRatingsReader(p, batch_size=256, repeat=True, seed=3))
    seen = [next(it) for _ in range(6)]  # two epochs of 3 batches
    assert all(b["user"].shape[0] == 256 for b in seen)
    assert not np.array_equal(seen[0]["user"], seen[3]["user"])
    jax_it = iter(JMovieLensRatingsReader(p, batch_size=256, repeat=True,
                                        seed=3))
    _same_batches(seen, [next(jax_it) for _ in range(6)])


def test_profiling_helpers(tmp_path):
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(2):
            timer.start()
            with profiling.annotate("outer_step"):
                with profiling.named_scope("inner_op"):
                    x = torch.ones(64, 64) @ torch.ones(64, 64)
            timer.stop(x)
    assert len(timer.times) == 2 and timer.mean_ms > 0
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    with open(prof.trace_path) as f:
        text = f.read()
    assert "outer_step" in text and "inner_op" in text
    assert profiling.StepTimer().mean_ms == 0.0
