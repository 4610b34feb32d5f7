"""The port's process-group exchange (``parallel.GroupMesh``): two CPU
processes on gloo, one shard each, against the in-process mesh of 2
shards.

Each rank passes its slice of every global batch through 3 lookup +
apply steps of a sharded Adagrad table: its half (block ``r``, as the
in-process mesh splits the batch), or slices of 40 and 56 keys at a
capacity factor of 1, where K is below the block length (the ranks agree
on the longest slice and branch alike through the hot-key guard). Each
rank then broadcasts a dense tensor from rank 0
(``DEHvdBroadcastGlobalVariablesCallback``) and saves its shard files
(``_mht_<r+1>of2_rank<r>_size2``) through ``multihost.save_checkpoint``.
The parent runs the same steps on an in-process mesh of 2 CPU shards,
each rank's slice padded with EMPTY keys (and zero grads) to the longest:
every shard's key planes, scores and rows must be bit-equal to the
rank's (the same operations on the same inputs in the same order), and
restoring the ranks' files in process takes the direct path and gives
the same rows. The processes import no JAX.
"""

import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

S, DIM, STEPS, N = 2, 8, 3, 96
# each rank's slice of a global batch, and the table's capacity factor
SPLITS = {"even": ((slice(0, 48), slice(48, 96)), 2.0),
          "uneven": ((slice(0, 40), slice(40, 96)), 1.0)}


def _batches():
    rng = np.random.default_rng(4)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(1, 150, size=N).astype(np.int64)
        g = rng.normal(size=(N, DIM)).astype(np.float32)
        out.append((ids, g))
    return out


def _table(mesh, split):
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch import parallel

    var = de.Variable(name="mp", dim=DIM, init_capacity=1 << 10,
                      initializer=de.initializers.uniform(0.05),
                      device="cpu")
    return (parallel.ShardedVariable(var, mesh,
                                     capacity_factor=SPLITS[split][1]),
            de.Adagrad(0.1))


def _train(sv, opt, split, rank=None):
    """3 steps; ``rank`` None: every rank's slice padded to the longest
    (in process), else the rank's slice."""
    slices = SPLITS[split][0]
    width = max(sl.stop - sl.start for sl in slices)
    st = sv.create_slots(sv.init(), opt)
    for t, (ids, g) in enumerate(_batches()):
        if rank is not None:
            ids, g = ids[slices[rank]], g[slices[rank]]
        else:
            pad = [width - (sl.stop - sl.start) for sl in slices]
            ids = np.concatenate([np.pad(ids[sl], (0, p), constant_values=(
                sv.spec.empty_key)) for sl, p in zip(slices, pad)])
            g = np.concatenate([np.pad(g[sl], ((0, p), (0, 0)))
                                for sl, p in zip(slices, pad)])
        _, ctx = sv.embedding_lookup(st, torch.from_numpy(ids), step=t)
        st = sv.apply_gradients(st, ctx, torch.from_numpy(g), opt, step=t)
    return st


def _worker(rank, port, out_dir, split):
    import sys

    import torch.distributed as dist

    from recommenders_addons_tpu_torch.keras.callbacks import (
        DEHvdBroadcastGlobalVariablesCallback,
    )
    from recommenders_addons_tpu_torch.parallel import multihost
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    multihost.initialize(f"tcp://127.0.0.1:{port}", world_size=S,
                         rank=rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(device="cpu")
        assert multihost.process_rank_size() == (rank, S)
        placed = multihost.shard_batch(mesh, {"x": np.arange(3)})
        assert placed["x"].device == mesh.device
        sv, opt = _table(mesh, split)
        st = _train(sv, opt, split, rank)
        (shard,) = st.shards
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 key_lo=shard.key_lo.numpy(), key_hi=shard.key_hi.numpy(),
                 scores=shard.scores.numpy(), rows=shard.rows.numpy(),
                 size=int(sv.size(st)), shard_ids=np.asarray(st.shard_ids))
        got = DEHvdBroadcastGlobalVariablesCallback()(
            {"w": torch.full((3,), float(rank + 1)), "table": st}, mesh)
        np.save(os.path.join(out_dir, f"bcast{rank}.npy"), got["w"].numpy())
        multihost.save_checkpoint(ckpt.DECheckpoint(table=sv),
                                  os.path.join(out_dir, "ckpt"),
                                  {"table": st})
        dist.barrier()
        if "jax" in sys.modules:
            raise AssertionError("a rank imported JAX")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_two_ranks_on_gloo_match_the_in_process_mesh(tmp_path, split):
    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(tmp_path), split))
             for r in range(S)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * S

    sv, opt = _table(parallel.create_mesh(devices=["cpu"] * S), split)
    st = _train(sv, opt, split)
    for r, shard in enumerate(st.shards):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert int(got["shard_ids"][0]) == r
        for f in ("key_lo", "key_hi", "scores", "rows"):
            np.testing.assert_array_equal(got[f], getattr(shard, f).numpy(),
                                          err_msg=f"rank {r} {f}")
        assert int(got["size"]) == int(sv.size(st))
        np.testing.assert_array_equal(np.load(tmp_path / f"bcast{r}.npy"),
                                      np.ones(3, np.float32))

    vdir = tmp_path / "ckpt" / ckpt.DE_DIR_NAME / "mp"
    assert sorted(p.name for p in vdir.glob("*-keys")) == [
        f"mp_mht_{r + 1}of2_rank{r}_size2-keys" for r in range(S)]
    back = ckpt.load_dynamic_embedding(sv, sv.init(), str(tmp_path / "ckpt"))
    assert ckpt.LAST_RESTORE_USED_DIRECT
    probe = torch.arange(1, 150)
    assert torch.equal(sv.lookup(back, probe), sv.lookup(st, probe))


def test_group_mesh_defaults_to_the_card(tmp_path):
    """A gloo world of one: ``global_mesh()`` puts its shard on the card
    by default, so without a card it raises rather than train on the CPU;
    ``device="cpu"`` places it there."""
    import torch.distributed as dist

    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.parallel import multihost

    assert multihost.initialize(f"file://{tmp_path}/store", world_size=1,
                                rank=0, backend="gloo")
    try:
        if torch.cuda.is_available():
            assert multihost.global_mesh().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.global_mesh()
        mesh = multihost.global_mesh(device="cpu")
        assert isinstance(mesh, parallel.GroupMesh)
        assert mesh.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
