"""Neural-collaborative-filtering performance predictor (paper §3.1, [39]).

The port of ``repro.core.ncf``.  Performance prediction as matrix
completion: rows = applications, columns = (cpu_cap, gpu_cap) grid cells.
A NeuMF-style model (GMF branch: elementwise product of embeddings; MLP
branch: concatenated embeddings + numeric cap features, SiLU) predicts the
*log runtime ratio* of an (app, config) cell relative to the app's
fastest observed cell.

 * ``fit``           — offline training on historical apps, AdamW + MSE;
 * ``infer_app``     — online phase for an unseen app: shared parameters
                       frozen, only its two embedding vectors fit;
 * ``update_app``    — the same seeded fit from an accumulated buffer, so
                       an updated predictor equals a fresh ``infer_app``
                       on the same observations bit for bit;
 * ``update_apps``   — one stacked embedding fit for many apps;
 * ``predict_surface`` — the predicted surface over the full grid.

Parameters are float32 tensors on ``device`` under the reference's names
(``app_gmf``, ``app_mlp``, ``cfg_gmf``, ``cfg_mlp``, ``mlp[i].w/b``,
``head_w``, ``head_b``), so weights carry across by name
(:func:`repro_torch.interop.ncf_predictor_from_parts`).  Gradients come
from autograd, the update rule from :mod:`repro_torch.train.optimizer`.

Seeds: initial parameters, each app's initial embedding and the offline
minibatch indices come from ``torch.Generator``s on the host, seeded from
``cfg.seed`` (parameters), ``cfg.seed + 1`` (indices) and
``crc32(name)`` (embeddings) — where the reference seeds its
``jax.random`` keys — so the card and the host draw the same numbers.
Each may instead be injected (``fit(init_params=, indices=)``,
``NCFPredictor.embedding_init``).

Determinism on the card: an index gather's backward is a scatter-add
whose order varies there, so no fitted parameter is gathered by index.
The online fits write the app-embedding lookup as a broadcast and the
offline fit its four lookups as one-hot products, whose backwards are a
reduction and a matmul, so repeated fits give the same bits.  Every fit
and prediction runs its float32 matmuls in full float32 (the process's
setting is restored after): a TF32 product would round the one-hot
lookups and the MLP.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.surfaces import PowerSurface, TabulatedSurface
from repro_torch.core.types import SystemSpec
from repro_torch.device import resolve_device
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class NCFConfig:
    embed_dim: int = 16
    mlp_hidden: tuple[int, ...] = (64, 32)
    lr: float = 3e-3
    train_steps: int = 3000
    online_lr: float = 5e-2
    online_steps: int = 400
    batch_size: int = 512
    seed: int = 0


def _config_features(system: SystemSpec) -> np.ndarray:
    """Per-grid-cell numeric features in [0,1]: (c_norm, g_norm)."""
    grid = system.grid
    pairs = grid.pairs()
    c = (pairs[:, 0] - grid.cpu_min) / max(grid.cpu_max - grid.cpu_min, 1e-9)
    g = (pairs[:, 1] - grid.gpu_min) / max(grid.gpu_max - grid.gpu_min, 1e-9)
    return np.stack([c, g], axis=-1).astype(np.float32)


def _init_params(
    generator: torch.Generator, n_apps: int, n_cfgs: int, cfg: NCFConfig
) -> dict:
    """Initial parameters (host float32), drawn from ``generator``."""
    d = cfg.embed_dim

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    scale = 0.1
    feat_dim = 2
    out = {
        "app_gmf": scale * normal(n_apps, d),
        "app_mlp": scale * normal(n_apps, d),
        "cfg_gmf": scale * normal(n_cfgs, d),
        "cfg_mlp": scale * normal(n_cfgs, d),
    }
    dims = (2 * d + feat_dim,) + tuple(cfg.mlp_hidden)
    out["mlp"] = [
        {
            "w": normal(din, dout) * float(np.sqrt(2.0 / din)),
            "b": torch.zeros((dout,)),
        }
        for din, dout in zip(dims[:-1], dims[1:])
    ]
    head_in = d + cfg.mlp_hidden[-1]
    out["head_w"] = normal(head_in, 1) * float(np.sqrt(1.0 / head_in))
    out["head_b"] = torch.zeros((1,))
    return out


def _to_device(tree, device: torch.device):
    """float32 tensors on ``device`` from a tree of arrays or tensors."""

    def one(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=device, dtype=torch.float32)

    return opt.tree_map(one, tree)


def _mix(params, ag, am, cg, cm, cfg_feats) -> torch.Tensor:
    """The model on gathered embedding rows."""
    gmf = ag * cg
    h = torch.cat([am, cm, cfg_feats], dim=-1)
    for layer in params["mlp"]:
        h = F.silu(h @ layer["w"] + layer["b"])
    z = torch.cat([gmf, h], dim=-1)
    return (z @ params["head_w"] + params["head_b"])[..., 0]


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as a one-hot product: exact in full float32, and its
    backward is a matmul, where the gather's is a scatter-add."""
    return F.one_hot(ids, table.shape[0]).to(table.dtype) @ table


def _forward(params, app_ids, cfg_ids, cfg_feats) -> torch.Tensor:
    return _mix(
        params,
        _rows(params["app_gmf"], app_ids),
        _rows(params["app_mlp"], app_ids),
        _rows(params["cfg_gmf"], cfg_ids),
        _rows(params["cfg_mlp"], cfg_ids),
        cfg_feats,
    )


def _value_and_grad(loss_fn: Callable, tree, *args):
    """(loss, gradient tree) of ``loss_fn(tree, *args)`` in ``tree``."""
    leaves = [x.detach().requires_grad_(True) for x in opt.tree_leaves(tree)]
    it = iter(leaves)
    live = opt.tree_map(lambda _: next(it), tree)
    with torch.enable_grad():
        loss = loss_fn(live, *args)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), opt.tree_map(lambda _: next(it), tree)


@contextlib.contextmanager
def _full_float32():
    """float32 matmuls in full float32 for the block (restored after)."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)


def _cell_index(system: SystemSpec) -> dict[tuple[float, float], int]:
    pairs = system.grid.pairs()
    return {(round(c, 3), round(g, 3)): i for i, (c, g) in enumerate(pairs)}


@dataclasses.dataclass
class NCFPredictor:
    """Trained predictor bound to one system's cap grid, on ``device``
    (None = the CUDA card).  ``params`` may be given as numpy arrays: they
    become float32 tensors on the device."""

    system: SystemSpec
    cfg: NCFConfig
    params: dict
    app_index: dict[str, int]
    cfg_feats: np.ndarray  # [C, 2]
    device: str | torch.device | None = None
    #: optional ``name -> {"gmf": [1, d], "mlp": [1, d]}`` initial online
    #: embeddings in place of the crc32-seeded draw
    embedding_init: Callable[[str], Mapping] | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = _to_device(self.params, self.device)

    # -- construction -------------------------------------------------------

    @staticmethod
    def fit(
        system: SystemSpec,
        observations: Mapping[str, Mapping[tuple[float, float], float]],
        cfg: NCFConfig = NCFConfig(),
        *,
        device: str | torch.device | None = None,
        init_params: dict | None = None,
        indices=None,
    ) -> "NCFPredictor":
        """Train on historical apps.

        ``observations[app][(c, g)] = measured runtime`` — any subset of
        the grid per app; targets are log-ratios vs the app's fastest
        observed cell.  ``init_params`` (a parameter tree) and ``indices``
        (``[train_steps, batch_size]`` observation indices, one row a step)
        replace the seeded draws.
        """
        dev = resolve_device(device)
        cell_of = _cell_index(system)
        app_index = {name: i for i, name in enumerate(sorted(observations))}
        rows, cols, ys = [], [], []
        for name, obs in observations.items():
            ref = min(obs.values())  # fastest observed ~ max-cap runtime
            for (c, g), t in obs.items():
                key = (round(c, 3), round(g, 3))
                if key not in cell_of:
                    raise KeyError(f"({c},{g}) not on the {system.name} grid")
                rows.append(app_index[name])
                cols.append(cell_of[key])
                ys.append(np.log(t / ref))
        n_obs = len(rows)
        feats_np = _config_features(system)
        if init_params is None:
            init_params = _init_params(
                torch.Generator().manual_seed(cfg.seed),
                len(app_index), len(feats_np), cfg,
            )
        if indices is None:
            indices = torch.randint(
                0, n_obs, (cfg.train_steps, cfg.batch_size),
                generator=torch.Generator().manual_seed(cfg.seed + 1),
            )
        idx = torch.as_tensor(indices).to(torch.int64)
        if tuple(idx.shape) != (cfg.train_steps, cfg.batch_size):
            raise ValueError(
                f"indices must be [{cfg.train_steps}, {cfg.batch_size}], "
                f"got {list(idx.shape)}"
            )
        if n_obs and (int(idx.min()) < 0 or int(idx.max()) >= n_obs):
            raise ValueError(f"indices must lie in [0, {n_obs})")
        # every step's minibatch gathered up front: one upload, no
        # per-step host work beyond the launches
        idx = idx.to(dev)
        step_rows = torch.as_tensor(np.array(rows, np.int64), device=dev)[idx]
        step_cols = torch.as_tensor(np.array(cols, np.int64), device=dev)[idx]
        step_ys = torch.as_tensor(np.array(ys, np.float32), device=dev)[idx]
        step_feats = torch.as_tensor(feats_np, device=dev)[step_cols]

        def loss_fn(p, i):
            pred = _forward(p, step_rows[i], step_cols[i], step_feats[i])
            return torch.mean((pred - step_ys[i]) ** 2)

        params = _to_device(init_params, dev)
        optimizer = opt.adamw(cfg.lr)
        state = optimizer.init(params)
        with _full_float32():
            for i in range(cfg.train_steps):
                _, grads = _value_and_grad(loss_fn, params, i)
                params, state = optimizer.update(grads, state, params)
        return NCFPredictor(
            system=system,
            cfg=cfg,
            params=params,
            app_index=app_index,
            cfg_feats=feats_np,
            device=dev,
        )

    # -- online phase for unseen apps ---------------------------------------

    def has_app(self, name: str) -> bool:
        return name in self.app_index

    def _sample_arrays(
        self, samples: Mapping[tuple[float, float], float]
    ) -> tuple[np.ndarray, np.ndarray]:
        """(grid-cell ids, log-runtime-ratio targets) for one app's samples,
        against the fastest observed runtime, as in :meth:`fit`."""
        cell_of = _cell_index(self.system)
        ref = min(samples.values())
        cols = np.array(
            [cell_of[(round(c, 3), round(g, 3))] for c, g in samples], np.int32
        )
        ys = np.array([np.log(t / ref) for t in samples.values()], np.float32)
        return cols, ys

    @staticmethod
    def _app_seed(name: str) -> int:
        return zlib.crc32(name.encode()) % (2**31)

    def _init_embedding(self, name: str) -> dict:
        d = self.cfg.embed_dim
        if self.embedding_init is not None:
            e = _to_device(self.embedding_init(name), self.device)
            return {k: e[k].reshape(1, d) for k in ("gmf", "mlp")}
        g = torch.Generator().manual_seed(self._app_seed(name))
        gmf = 0.1 * torch.randn((1, d), generator=g)
        mlp = 0.1 * torch.randn((1, d), generator=g)
        return {"gmf": gmf.to(self.device), "mlp": mlp.to(self.device)}

    def _frozen(self) -> dict:
        return {k: v for k, v in self.params.items() if "app" not in k}

    def _fit_embedding(self, name: str, cols: np.ndarray, ys: np.ndarray) -> dict:
        """Online phase core: fit one app's embedding pair, shared params
        frozen.  Deterministic given (name, observations, shared params)."""
        dev = self.device
        frozen = self._frozen()
        cols_t = torch.as_tensor(cols, dtype=torch.int64, device=dev)
        ys_t = torch.as_tensor(ys, device=dev)
        feats = torch.as_tensor(self.cfg_feats, device=dev)[cols_t]
        cg, cm = frozen["cfg_gmf"][cols_t], frozen["cfg_mlp"][cols_t]
        k = len(cols)

        def loss_fn(e):
            # the one app row broadcast to every sample (backward: a sum)
            pred = _mix(
                frozen, e["gmf"].expand(k, -1), e["mlp"].expand(k, -1), cg, cm, feats
            )
            return torch.mean((pred - ys_t) ** 2)

        emb = self._init_embedding(name)
        optimizer = opt.adamw(self.cfg.online_lr)
        state = optimizer.init(emb)
        with _full_float32():
            for _ in range(self.cfg.online_steps):
                _, grads = _value_and_grad(loss_fn, emb)
                emb, state = optimizer.update(grads, state, emb)
        return emb

    def _with_embeddings(self, emb_by_app: Mapping[str, dict]) -> "NCFPredictor":
        """New predictor with the given (1, d) embedding pairs written in:
        known apps have their row replaced, new apps are appended in sorted
        name order."""
        gmf = self.params["app_gmf"].clone()
        mlp = self.params["app_mlp"].clone()
        new_index = dict(self.app_index)
        appended_g, appended_m = [], []
        for name in sorted(emb_by_app):
            e = _to_device(emb_by_app[name], self.device)
            if name in new_index:
                gmf[new_index[name]] = e["gmf"][0]
                mlp[new_index[name]] = e["mlp"][0]
            else:
                new_index[name] = len(new_index)
                appended_g.append(e["gmf"])
                appended_m.append(e["mlp"])
        if appended_g:
            gmf = torch.cat([gmf] + appended_g, dim=0)
            mlp = torch.cat([mlp] + appended_m, dim=0)
        new_params = dict(self.params)
        new_params["app_gmf"] = gmf
        new_params["app_mlp"] = mlp
        return NCFPredictor(
            system=self.system,
            cfg=self.cfg,
            params=new_params,
            app_index=new_index,
            cfg_feats=self.cfg_feats,
            device=self.device,
            embedding_init=self.embedding_init,
        )

    def infer_app(
        self, name: str, samples: Mapping[tuple[float, float], float]
    ) -> "NCFPredictor":
        """Fit embeddings for an unseen app from K online-profiled samples
        (shared parameters frozen); returns a new predictor whose app table
        includes ``name``."""
        cols, ys = self._sample_arrays(samples)
        return self._with_embeddings({name: self._fit_embedding(name, cols, ys)})

    def update_app(
        self, name: str, samples: Mapping[tuple[float, float], float]
    ) -> "NCFPredictor":
        """Re-fit ``name``'s embeddings from its full accumulated
        observation set: the same seeded fit as :meth:`infer_app`, so the
        result equals a from-scratch ``infer_app`` bit for bit."""
        return self.infer_app(name, samples)

    def update_apps(
        self,
        samples_by_app: Mapping[str, Mapping[tuple[float, float], float]],
    ) -> "NCFPredictor":
        """Batched online phase: every listed app's embedding pair in one
        stacked optimization.  Per-app losses are independent and AdamW is
        elementwise, so each row follows its standalone :meth:`update_app`
        trajectory up to float reduction order.  Short apps are padded and
        masked."""
        names = sorted(samples_by_app)
        if not names:
            return self
        if len(names) == 1:
            return self.update_app(names[0], samples_by_app[names[0]])
        arrays = [self._sample_arrays(samples_by_app[n]) for n in names]
        n_apps = len(names)
        k_max = max(len(c) for c, _ in arrays)
        cols = np.zeros((n_apps, k_max), np.int64)
        ys = np.zeros((n_apps, k_max), np.float32)
        mask = np.zeros((n_apps, k_max), np.float32)
        for i, (c, y) in enumerate(arrays):
            cols[i, : len(c)] = c
            ys[i, : len(y)] = y
            mask[i, : len(c)] = 1.0
        dev = self.device
        counts = torch.as_tensor(mask.sum(axis=1), device=dev)
        cols_t = torch.as_tensor(cols, device=dev)
        ys_t = torch.as_tensor(ys, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        frozen = self._frozen()
        feats = torch.as_tensor(self.cfg_feats, device=dev)[cols_t]
        cg, cm = frozen["cfg_gmf"][cols_t], frozen["cfg_mlp"][cols_t]
        inits = [self._init_embedding(n) for n in names]
        emb = {k: torch.cat([e[k] for e in inits], dim=0) for k in ("gmf", "mlp")}

        def loss_fn(e):
            d = e["gmf"].shape[-1]
            pred = _mix(
                frozen,
                e["gmf"][:, None, :].expand(n_apps, k_max, d),
                e["mlp"][:, None, :].expand(n_apps, k_max, d),
                cg, cm, feats,
            )
            per_app = torch.sum(mask_t * (pred - ys_t) ** 2, dim=1) / counts
            # sum (not mean) over apps: each row's gradient equals its
            # standalone single-app gradient
            return torch.sum(per_app)

        optimizer = opt.adamw(self.cfg.online_lr)
        state = optimizer.init(emb)
        with _full_float32():
            for _ in range(self.cfg.online_steps):
                _, grads = _value_and_grad(loss_fn, emb)
                emb, state = optimizer.update(grads, state, emb)
        return self._with_embeddings(
            {
                name: {"gmf": emb["gmf"][i : i + 1], "mlp": emb["mlp"][i : i + 1]}
                for i, name in enumerate(names)
            }
        )

    # -- prediction ----------------------------------------------------------

    def predict_log_ratios(self, name: str) -> np.ndarray:
        """Predicted log runtime ratio for every grid cell, float32 [C]."""
        if name not in self.app_index:
            raise KeyError(f"{name} unknown; call infer_app first")
        n = self.cfg_feats.shape[0]
        dev = self.device
        with torch.no_grad(), _full_float32():
            out = _forward(
                self.params,
                torch.full((n,), self.app_index[name], dtype=torch.int64, device=dev),
                torch.arange(n, device=dev),
                torch.as_tensor(self.cfg_feats, device=dev),
            )
        return out.cpu().numpy()

    def predict_surface(self, name: str) -> PowerSurface:
        """Predicted runtime surface (arbitrary scale) over the full grid;
        the table is float32, as the reference's."""
        grid = self.system.grid
        ratios = np.exp(self.predict_log_ratios(name))
        n_c, n_g = len(grid.cpu_levels), len(grid.gpu_levels)
        return TabulatedSurface(
            cpu_levels=grid.cpu_levels,
            gpu_levels=grid.gpu_levels,
            table=ratios.reshape(n_c, n_g),
        )
