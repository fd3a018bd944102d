"""Optimizers and schedules over trees of tensors (no ``torch.optim``).

The port of ``repro.train.optimizer``: an (init, update) pair for AdamW
with decoupled weight decay, global-norm clipping, a weight-decay mask,
Adafactor-style factored second moments and chunked leaf updates, plus
the warmup + cosine schedule.  A tree is a tensor or a nested dict, list
or tuple of them; ``update`` is functional (it returns new tensors and a
new state and writes nothing in place), with all update math in float32.
Used by the NCF predictor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree, is_leaf=None) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure (dict, list,
    tuple; anything else, or what ``is_leaf`` accepts, is a leaf)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {
            k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, v in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[..., tuple[Tree, Any]]


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree))
    )


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    # keep each gradient's dtype (a float32 scale would upcast bf16 leaves)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _is_factored(x) -> bool:
    return isinstance(x, dict) and set(x) == {"row", "col"}


def adamw(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float | None = None,
    mask: Callable[[Tree], Tree] | None = None,
    factored: bool = False,
    moment_dtype: torch.dtype = torch.float32,
    update_chunks: int = 1,
) -> Optimizer:
    """AdamW with optional clipping, weight-decay mask and factored second
    moments, the reference's update rule leaf for leaf.

    ``factored=True`` keeps (row, col) second-moment factors for leaves of
    two or more dims instead of a full ``nu``; ``moment_dtype`` is the
    first moment's storage type; ``update_chunks > 1`` updates large
    stacked leaves (ndim >= 3, >= 2**22 elements, leading dim divisible)
    chunk by chunk along the leading dim, bounding the float32 transients.
    """

    def _nu_init(p):
        if factored and p.ndim >= 2:
            return {
                "row": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                "col": torch.zeros(
                    p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device
                ),
            }
        return torch.zeros_like(p, dtype=torch.float32)

    def init(params: Tree) -> AdamState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=moment_dtype), params),
            nu=tree_map(_nu_init, params),
        )

    def _nu_update_and_v(nu, g):
        g2 = torch.square(g.float()) + 1e-30
        if isinstance(nu, dict):  # factored
            row = b2 * nu["row"] + (1 - b2) * torch.mean(g2, dim=-1)
            col = b2 * nu["col"] + (1 - b2) * torch.mean(g2, dim=-2)
            v = (
                row[..., :, None]
                * col[..., None, :]
                / torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=1e-30)[
                    ..., None
                ]
            )
            return {"row": row, "col": col}, v
        nu_new = b2 * nu + (1 - b2) * g2
        return nu_new, nu_new

    def update(grads: Tree, state: AdamState, params: Tree):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        step_f = step.float()
        b1c = 1.0 - torch.pow(torch.full_like(step_f, b1), step_f)
        b2c = 1.0 - torch.pow(torch.full_like(step_f, b2), step_f)
        decay_mask = (
            mask(params) if mask is not None else tree_map(lambda _: True, params)
        )

        def leaf_update(p, m, nu, g, dm):
            """(p_new, m_new, nu_new) for one leaf, float32 math."""
            m_new = (b1 * m.float() + (1 - b1) * g.float()).to(moment_dtype)
            nu_new, v = _nu_update_and_v(nu, g)
            upd = (m_new.float() / b1c) / (torch.sqrt(v / b2c) + eps)
            if weight_decay:
                wd = (
                    torch.where(dm, weight_decay, 0.0)
                    if isinstance(dm, torch.Tensor)
                    else (weight_decay if dm else 0.0)
                )
                upd = upd + wd * p.float()
            p_new = (p.float() - lr * upd).to(p.dtype)
            return p_new, m_new, nu_new

        def maybe_chunked(p, m, nu, g, dm):
            chunkable = (
                update_chunks > 1
                and p.ndim >= 3
                and p.shape[0] % update_chunks == 0
                and p.numel() >= 1 << 22
            )
            if not chunkable:
                return leaf_update(p, m, nu, g, dm)

            def chunks(x):
                return torch.chunk(x, update_chunks, dim=0)

            cp, cm, cg = chunks(p), chunks(m), chunks(g)
            cnu = (
                [{"row": r, "col": c} for r, c in zip(chunks(nu["row"]), chunks(nu["col"]))]
                if isinstance(nu, dict)
                else chunks(nu)
            )
            outs = [
                leaf_update(cp[i], cm[i], cnu[i], cg[i], dm)
                for i in range(update_chunks)
            ]
            p_new = torch.cat([o[0] for o in outs])
            m_new = torch.cat([o[1] for o in outs])
            if isinstance(nu, dict):
                nu_new = {
                    k: torch.cat([o[2][k] for o in outs]) for k in ("row", "col")
                }
            else:
                nu_new = torch.cat([o[2] for o in outs])
            return p_new, m_new, nu_new

        with torch.no_grad():
            triples = tree_map(
                maybe_chunked, params, state.mu, state.nu, grads, decay_mask,
                is_leaf=_is_factored,
            )

        def unpack(i):
            return tree_map(
                lambda t: t[i], triples, is_leaf=lambda x: isinstance(x, tuple)
            )

        return unpack(0), AdamState(step=step, mu=unpack(1), nu=unpack(2))

    return Optimizer(init=init, update=update)


def warmup_cosine(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    *,
    min_ratio: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup then cosine decay to ``min_ratio * peak_lr``."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = peak_lr * (
            min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        )
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
