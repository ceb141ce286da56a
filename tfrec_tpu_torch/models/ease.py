"""EASE, the embarrassingly shallow autoencoder (Steck 2019), the
closed-form item-item model beside WRMF.

The counterpart of ``tfrec_tpu/models/ease.py``. The model is one item-item
matrix with a zero diagonal:

    B = argmin |X - XB|² + λ|B|²  s.t. diag(B) = 0
      = I - P diag(1/diag(P)),   P = (XᵀX + λI)⁻¹

so training is one Gram product and one Cholesky solve against the
identity (``EASETrainer``, ``torch.linalg.cholesky`` and
``cholesky_solve``), in f32 without TF32; the diagonal is exactly 0, as
P_ii / P_ii is 1. It holds dense [V, V] and [U, V] matrices, so it refuses
catalogs past ``MAX_ITEMS`` and train matrices past ``MAX_ELEMENTS``.

The solution is stored transposed, ``ease_bt``, so that ``predict`` reads
the score column of item i as row i through the gather kernel, dotted with
the user's train row (``pointwise_batch_extras``); the binary train matrix
``ease_x`` rides in the state beside it, so a checkpoint is whole. A user
batch's catalog is its rows of ``ease_x`` (one gather launch) times B, and
the sampled eval gathers its candidates from that row
(``score_user_items``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.models.base import DataSpec, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many
from tfrec_tpu_torch.train.als import no_tf32


class EASETrainer:
    """The one-shot ridge solve; ``epoch`` solves again from the same
    train matrix (the config runs one)."""

    def __init__(self, dataset, model: "EASE", reg: float, device: torch.device | str = "cpu"):
        self.model = model
        self.reg = reg
        nu, ni = dataset.num_users, dataset.num_items
        x = np.zeros((nu, ni), np.float32)
        x[dataset.train.users, dataset.train.items] = 1.0
        self.x = torch.from_numpy(x).to(device)
        self.bt = torch.zeros((ni, ni), dtype=torch.float32, device=device)
        model.attach_history_matrix(self.x)

    def solve(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B [V, V], the objective at B) for the train matrix ``x``."""
        eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
        with no_tf32():
            gram = x.T @ x + self.reg * eye
            p = torch.cholesky_solve(eye, torch.linalg.cholesky(gram))
            b = eye - p / torch.diagonal(p)[None, :]
            recon = x @ b
        return b, ((x - recon) ** 2).sum() + self.reg * (b * b).sum()

    def epoch(self) -> Dict[str, float]:
        b, loss = self.solve(self.x)
        self.bt = b.T.contiguous()
        return {"loss": float(loss)}

    def tables(self) -> Dict[str, torch.Tensor]:
        return {"ease_bt": self.bt, "ease_x": self.x}

    def load(self, tables: Dict[str, torch.Tensor]) -> None:
        self.bt = tables["ease_bt"].to(self.x.device, torch.float32).contiguous()
        self.x = tables["ease_x"].to(self.x.device, torch.float32).contiguous()
        self.model.attach_history_matrix(self.x)


class EASE(RecModel):
    solver_loss_name = "ease"
    # Dense-matrix budgets (f32 elements), refused loudly: the [V, V] solve
    # and the [U, V] train matrix must both fit.
    MAX_ITEMS = 32768
    MAX_ELEMENTS = 1 << 28  # ~1 GB f32 for the [U, V] matrix

    def __init__(self, data_spec: DataSpec, reg: float = 100.0, max_items: int | None = None):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"EASE needs an interaction DataSpec, got {data_spec.kind!r}")
        max_items = self.MAX_ITEMS if max_items is None else max_items
        if data_spec.num_items > max_items:
            raise ValueError(
                f"EASE holds a dense [V, V] item matrix; V={data_spec.num_items} exceeds "
                f"max_items={max_items} (V^2 memory). Use wrmf/mf for large catalogs.")
        if data_spec.num_users * data_spec.num_items > self.MAX_ELEMENTS:
            raise ValueError(
                f"EASE builds a dense [U, V] train matrix; {data_spec.num_users} x "
                f"{data_spec.num_items} exceeds {self.MAX_ELEMENTS} f32 elements (~1 GB). Use wrmf/mf "
                "for this scale.")
        self.data_spec = data_spec
        self.reg = reg
        self._x = None  # the [U, V] binary train matrix (the solver attaches it)

    def make_solver(self, dataset, *, batch: int, seed: int, mesh=None, device="cpu"):
        # The [V, V] solve is one dense op: every rank solves it whole.
        return EASETrainer(dataset, self, self.reg, device=device)

    def solved_tables(self) -> Tuple[str, ...]:
        return ("ease_bt", "ease_x")

    def attach_history_matrix(self, x: torch.Tensor) -> None:
        self._x = x

    def pointwise_batch_extras(self, user_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``predict``'s extra batch entry: the users' train rows."""
        if self._x is None:
            raise ValueError("EASE scoring needs the train matrix; run the Trainer (its solver "
                             "attaches it) before evaluate/serve")
        return {"hist_x": self._x[user_ids.long()]}

    def table_specs(self) -> Tuple[TableSpec, ...]:
        return ()

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        if "item" in batch and "hist_x" in batch:
            return {"ease_bt": batch["item"]}  # row i of Bᵀ is score column i of B
        return {}

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        if self.is_pairwise(batch):
            raise ValueError("EASE has no SGD objective; it trains closed-form")
        return (batch["hist_x"] * gathered["ease_bt"]).sum(dim=-1)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V]: the users' rows of ``ease_x`` (one gather launch) times B."""
        t = params["tables"]
        (x,) = gather_many([t["ease_x"]], [user_ids])
        with no_tf32():
            return torch.matmul(x, t["ease_bt"].T)

    def score_user_items(self, params, user_ids: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
        """The sampled eval's path: each user's catalog row, then its
        candidates [B, C]."""
        return torch.gather(self.score_all(params, user_ids), 1, item_ids.long())
