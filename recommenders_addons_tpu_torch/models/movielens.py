"""MovieLens rating model — the port of the JAX package's
``models/movielens.py`` (the reference's minimal end-to-end demo): two
dynamic embeddings (user, movie) and a dense MLP regressor.

The multi-hot variant adds a third table, genres, looked up through
``safe_embedding_lookup_sparse(..., combiner="mean")`` and trained
through ``apply_sparse_gradients``; a batch's genre rows are padded with
EMPTY ids, which the apply sends to the trash row. All three tables
train with the row-wise ``Adam`` (the fused optimizer-scatter kernel),
the MLP with plain SGD.

With ``mesh=`` each table is a ``parallel.ShardedVariable``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.common import on_device, sgd_
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class MovieLensConfig:
    dim: int = 32
    hidden: Tuple[int, ...] = (64, 16, 1)
    user_capacity: int = 1 << 16
    movie_capacity: int = 1 << 14
    genre_capacity: int = 1 << 8
    multi_hot_genres: bool = False
    max_genres: int = 4
    lr: float = 0.05


@dataclasses.dataclass
class MovieLensState:
    user: Any
    movie: Any
    genre: Any  # () without multi-hot genres
    dense: MLP  # updated in place by the train step
    step: int


class MovieLensModel:
    def __init__(self, cfg: MovieLensConfig = MovieLensConfig(), mesh=None,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        init = de.initializers.normal(0.05)

        def make(name, cap):
            var = de.Variable(name=name, dim=cfg.dim, init_capacity=cap,
                              initializer=init, device=self.device)
            return ShardedVariable(var, mesh) if mesh is not None else var

        self.user = make("ml_user", cfg.user_capacity)
        self.movie = make("ml_movie", cfg.movie_capacity)
        self.genre = (make("ml_genre", cfg.genre_capacity)
                      if cfg.multi_hot_genres else None)
        self.opt = de.Adam(cfg.lr)

    def init(self, seed: int = 0) -> MovieLensState:
        cfg = self.cfg
        n_emb = 3 if cfg.multi_hot_genres else 2
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dense = MLP((cfg.dim * n_emb,) + cfg.hidden, device=self.device,
                    generator=gen)
        return MovieLensState(
            user=self.user.init(), movie=self.movie.init(),
            genre=self.genre.init() if self.genre else (),
            dense=dense, step=0)

    def _genre_lookup(self, state, batch, training):
        """The multi-hot genre rows (the sharded lookup under a mesh)."""
        g = self.genre
        sharded = g if self.mesh is not None else None
        return de.safe_embedding_lookup_sparse(
            g.var if sharded is not None else g, state.genre,
            batch["genres"], combiner="mean", training=training,
            sharded=sharded)

    def make_train_step(self):
        """``train_step(state, batch) -> (state, loss)``; the table rows
        and the MLP are updated in place."""
        cfg = self.cfg

        def train_step(state: MovieLensState, batch):
            u_emb, u_ctx = self.user.embedding_lookup(state.user,
                                                      batch["user"])
            m_emb, m_ctx = self.movie.embedding_lookup(state.movie,
                                                       batch["movie"])
            embs = [u_emb, m_emb]
            if cfg.multi_hot_genres:
                g_emb, g_ctx = self._genre_lookup(state, batch, True)
                embs.append(g_emb)
            embs = [e.detach().requires_grad_(True) for e in embs]
            params = list(state.dense.parameters())
            pred = state.dense(torch.cat(embs, dim=-1))[:, 0]
            loss = ((pred - batch["rating"]) ** 2).mean()
            grads = torch.autograd.grad(loss, params + embs)
            gd, ge = grads[:len(params)], grads[len(params):]
            user = self.user.apply_gradients(state.user, u_ctx, ge[0],
                                             self.opt, step=state.step)
            movie = self.movie.apply_gradients(state.movie, m_ctx, ge[1],
                                               self.opt, step=state.step)
            genre = state.genre
            if cfg.multi_hot_genres:
                genre = de.apply_sparse_gradients(
                    self.genre, state.genre, g_ctx, ge[2], self.opt,
                    step=state.step)
            sgd_(params, gd, 0.01)
            return (MovieLensState(user=user, movie=movie, genre=genre,
                                   dense=state.dense, step=state.step + 1),
                    loss.detach())

        return train_step

    @torch.no_grad()
    def predict(self, state: MovieLensState, batch):
        feats = [self.user.lookup(state.user, batch["user"]),
                 self.movie.lookup(state.movie, batch["movie"])]
        if self.cfg.multi_hot_genres:
            feats.append(self._genre_lookup(state, batch, False))
        return state.dense(torch.cat(feats, dim=-1))[:, 0]


def synthetic_movielens_batch(rng: np.random.Generator, batch_size: int,
                              num_users: int = 6040, num_movies: int = 3706,
                              max_genres: int = 4, multi_hot: bool = False):
    """MovieLens-1M-like synthetic batch with a latent-factor signal
    (numpy arrays; the same draws as the JAX package's)."""
    users = rng.integers(1, num_users + 1, size=batch_size).astype(np.int64)
    movies = rng.integers(1, num_movies + 1, size=batch_size).astype(np.int64)
    uf = np.sin(users * 0.37) + np.cos(users * 0.11)
    mf = np.sin(movies * 0.53) + np.cos(movies * 0.29)
    rating = np.clip(3.0 + uf * mf, 1.0, 5.0).astype(np.float32)
    batch = {"user": users, "movie": movies, "rating": rating}
    if multi_hot:
        n_g = rng.integers(1, max_genres + 1, size=batch_size)
        genres = np.full((batch_size, max_genres), int(de.EMPTY_KEY),
                         dtype=np.int64)
        for i, n in enumerate(n_g):
            genres[i, :n] = rng.integers(1, 19, size=n)
        batch["genres"] = genres
    return batch


def run_demo(steps: int = 200, batch_size: int = 256, multi_hot=False,
             mesh=None, seed: int = 0, log_every: int = 50, device=None):
    """End-to-end training demo; returns ``(train_mse, eval_mse)``."""
    dev = resolve_device(device)
    model = MovieLensModel(MovieLensConfig(multi_hot_genres=multi_hot),
                           mesh=mesh, device=dev)
    state = model.init(seed)
    train_step = model.make_train_step()
    rng = np.random.default_rng(seed)
    loss = None
    for t in range(steps):
        batch = on_device(synthetic_movielens_batch(
            rng, batch_size, multi_hot=multi_hot), dev)
        state, loss = train_step(state, batch)
        if log_every and t % log_every == 0:
            print(f"step {t}: train_mse={float(loss):.4f}")
    eval_batch = on_device(synthetic_movielens_batch(
        rng, 2048, multi_hot=multi_hot), dev)
    pred = model.predict(state, eval_batch)
    eval_mse = float(((pred - eval_batch["rating"]) ** 2).mean())
    return float(loss), eval_mse
