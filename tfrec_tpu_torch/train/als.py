"""Alternating least squares for implicit feedback (WRMF: Hu, Koren and
Volinsky 2008), the trainer of ``models/wrmf.WRMF``.

The counterpart of ``tfrec_tpu/train/als.py``. A half-sweep re-solves every
row of one side against the frozen other side Y:

- the Gram matrix ``G = Yᵀ Y`` is one [D, D] product;
- a batch of B rows solves ``(G + α Yᵤᵀ Yᵤ + λ I) xᵤ = (1 + α) Yᵤᵀ 1`` as
  one batched ``torch.linalg.solve`` over einsum-built [B, D, D] normal
  matrices, Yᵤ the rows of Y the row's history names (gathered from a
  sentinel-padded [B, H] history; padding rows solve to 0 and are cut).

The exact objective is computed each sweep through the trace identity
``Σ_all (xᵤᵀ yᵢ)² = Σ (XᵀX ∘ YᵀY)`` plus a pass over the nonzero positives,
with no U x V matrix (``make_objective``); ALS never raises it. Every
product runs in f32 without TF32, as the reference asks
``Precision.HIGHEST``: these feed matrix inverses.

On a data mesh (``parallel.mesh.Mesh``) each rank solves its stripe of
every batch and one ``all_gather`` over ``data`` joins the rows of a
half-sweep, the reference's GSPMD sharding of the batch axis; the frozen
side is replicated.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch


def padded_lists(rows: np.ndarray, cols: np.ndarray, num_rows: int,
                 sentinel: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row -> its columns, padded: (hist [num_rows, H] int32 padded with
    ``sentinel``, lens [num_rows] int32), H the largest row degree (never
    truncated: a dropped interaction would change the solution)."""
    order = np.argsort(rows, kind="stable")
    r, c = rows[order], cols[order]
    lens = np.bincount(r, minlength=num_rows)
    width = max(int(lens.max()) if len(r) else 0, 1)
    hist = np.full((num_rows, width), sentinel, np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    intra = np.arange(len(r)) - np.repeat(starts, lens)
    hist[r, intra] = c
    return hist, lens.astype(np.int32)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the cuBLAS products inside the block: f32, the
    reference's ``Precision.HIGHEST``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _solve_batch(other: torch.Tensor, gram: torch.Tensor, hist: torch.Tensor, alpha: float,
                 reg: float) -> torch.Tensor:
    """Closed-form rows [B, D] of one batch: ``hist`` [B, H] indexes
    ``other`` [N, D], the sentinel N being padding."""
    n, d = other.shape
    valid = (hist < n)[..., None]
    y = other[hist.clamp_max(n - 1).long()] * valid  # [B, H, D]
    a = gram[None] + alpha * torch.einsum("bhd,bhe->bde", y, y) + reg * torch.eye(
        d, dtype=other.dtype, device=other.device)[None]
    b = (1.0 + alpha) * y.sum(dim=1)
    return torch.linalg.solve(a, b[..., None])[..., 0]


def sweep_body(alpha: float, reg: float, mesh=None):
    """One half-sweep: ``sweep(other [N, D], hist_batches [nb, B, H]) ->
    [nb * B, D]``. On a ``mesh`` each rank solves its B / n rows of every
    batch and the result is all-gathered over ``data``."""

    def sweep(other: torch.Tensor, hist_batches: torch.Tensor) -> torch.Tensor:
        gram = other.T @ other
        if mesh is not None and mesh.size > 1:
            stripe = hist_batches.shape[1] // mesh.size
            lo = mesh.data_index * stripe
            hist_batches = hist_batches[:, lo:lo + stripe]
        out = torch.stack([_solve_batch(other, gram, h, alpha, reg) for h in hist_batches])
        if mesh is not None and mesh.size > 1:
            out = mesh.all_gather(out, dim=1)
        return out.reshape(-1, other.shape[1])

    return sweep


def make_sweep(alpha: float, reg: float, mesh=None):
    """A half-sweep function (``sweep_body``); the products in f32."""
    body = sweep_body(alpha, reg, mesh)

    def sweep(other, hist_batches):
        with no_tf32():
            return body(other, hist_batches)

    return sweep


def make_objective(alpha: float, reg: float):
    """The exact WRMF objective J = Σ_ui c_ui (p_ui - xᵤᵀyᵢ)² + λ(|X|² +
    |Y|²), c = 1 unobserved and 1 + α observed, through the trace identity;
    ``pos_u``/``pos_i`` are the train pairs."""

    def objective(x, y, pos_u, pos_i) -> torch.Tensor:
        with no_tf32():
            all_sq = ((x.T @ x) * (y.T @ y)).sum()  # Σ over all (u, i) of (xᵤᵀ yᵢ)²
        s = (x[pos_u.long()] * y[pos_i.long()]).sum(dim=-1)
        # An observed pair's background s² becomes (1 + α)(1 - s)².
        pos_term = ((1.0 + alpha) * (1.0 - s) ** 2 - s ** 2).sum()
        return all_sq + pos_term + reg * ((x * x).sum() + (y * y).sum())

    return objective


class ALSTrainer:
    """WRMF's sweeps over a train split, users' half then items' half. Each
    side's row count is padded to a multiple of ``batch`` with all-sentinel
    histories, whose rows solve to exactly 0 and are cut. On a ``mesh`` the
    batch is rounded up to a multiple of its data axis. ``generator`` draws
    the initial factors, N(0, 1/D), users' then items'; ``load`` takes
    another state (a checkpoint's, or the reference's)."""

    def __init__(self, dataset, embed_dim: int, alpha: float, reg: float, batch: int = 1024,
                 seed: int = 0, mesh=None, device: torch.device | str = "cpu"):
        nu, ni = dataset.num_users, dataset.num_items
        tr = dataset.train
        self.device = torch.device(device)
        self.num_users, self.num_items = nu, ni
        if mesh is not None:
            batch = -(-batch // mesh.size) * mesh.size
        u_hist, _ = padded_lists(tr.users, tr.items, nu, sentinel=ni)
        i_hist, _ = padded_lists(tr.items, tr.users, ni, sentinel=nu)
        self.u_hist = self._batched(u_hist, batch, ni)
        self.i_hist = self._batched(i_hist, batch, nu)
        self.pos_u = torch.from_numpy(tr.users.astype(np.int32)).to(self.device)
        self.pos_i = torch.from_numpy(tr.items.astype(np.int32)).to(self.device)
        self.sweep = make_sweep(alpha, reg, mesh=mesh)
        self.objective = make_objective(alpha, reg)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        scale = 1.0 / np.sqrt(embed_dim)
        self.x = torch.randn((nu, embed_dim), generator=generator, device=self.device) * scale
        self.y = torch.randn((ni, embed_dim), generator=generator, device=self.device) * scale

    def _batched(self, hist: np.ndarray, batch: int, sentinel: int) -> torch.Tensor:
        n, w = hist.shape
        pad = (-n) % batch
        if pad:
            hist = np.concatenate([hist, np.full((pad, w), sentinel, np.int32)])
        return torch.from_numpy(hist.reshape(-1, batch, w)).to(self.device)

    def epoch(self) -> Dict[str, float]:
        """One full sweep (users, then items); the exact objective after it."""
        self.x = self.sweep(self.y, self.u_hist)[: self.num_users]
        self.y = self.sweep(self.x, self.i_hist)[: self.num_items]
        return {"loss": float(self.objective(self.x, self.y, self.pos_u, self.pos_i))}

    def tables(self) -> Dict[str, torch.Tensor]:
        return {"user_emb": self.x, "item_emb": self.y}

    def load(self, tables: Dict[str, torch.Tensor]) -> None:
        """Resume from ``tables`` (copied to this solver's device)."""
        self.x = tables["user_emb"].to(self.device, torch.float32).contiguous()
        self.y = tables["item_emb"].to(self.device, torch.float32).contiguous()
