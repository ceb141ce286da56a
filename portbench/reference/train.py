"""The reference's first training steps of a CTR family: plain float32
PyTorch over the rows the steps touch, from the same initial weights.

Each table is held compact: the rows that the compared steps' ids reach,
regenerated from the seed by the benchmark, and the ids renumbered into
them. The dense params follow Adam, the rows rowwise Adagrad, each row's
gradient summed over the batch's duplicates of its id.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from portbench.reference.common import Adam, leaves, logloss, matmul_for, rebuild, rowwise_adagrad


def train_steps(logits: Callable, dense0, rows0: List[torch.Tensor], batches: List[dict],
                optim: dict, precision: str = "float32", keep_rows: int | None = None) -> dict:
    """``batches``: {"cat": [B, F] int64 compact row of each field's table,
    "dense", "label"}. -> {"losses": [...], "grad_norms": {leaf: float} of
    the first step's gradient, "change_norms": {leaf: float} after the last
    step}; leaves "dense.<path>" and "field_<t>". ``keep_rows`` keeps only
    the first rows of each batch (a fault the check must see)."""
    mm = matmul_for(precision)
    flat0 = leaves(dense0)
    params = {k: v.clone() for k, v in flat0.items()}
    tables = [r.clone() for r in rows0]
    accs = [torch.zeros(r.shape[0], dtype=torch.float32, device=r.device) for r in rows0]
    adam = Adam(params, optim["learning_rate"], optim["adam_b1"], optim["adam_b2"], optim["eps"])
    out: Dict[str, object] = {"losses": []}
    for s, b in enumerate(batches):
        if keep_rows is not None:
            b = {k: v[:keep_rows] for k, v in b.items()}
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        emb = torch.stack([t[b["cat"][:, f]] for f, t in enumerate(tables)], dim=1).requires_grad_()
        loss = logloss(logits(rebuild(dense0, p), emb, b["dense"], mm), b["label"])
        grads = torch.autograd.grad(loss, [*p.values(), emb])
        dense_g = dict(zip(p, grads[:-1]))
        row_g = []
        for f, t in enumerate(tables):
            g = torch.zeros_like(t).index_add_(0, b["cat"][:, f], grads[-1][:, f])
            touched = torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
            touched[b["cat"][:, f]] = True
            row_g.append((g, touched))
        if s == 0:
            norms = {f"dense.{k}": float(g.norm()) for k, g in dense_g.items()}
            norms.update({f"field_{f}": float(g.norm()) for f, (g, _) in enumerate(row_g)})
            out["grad_norms"] = norms
        params = {k: v.detach() for k, v in adam.step(params, dense_g).items()}
        with torch.no_grad():
            for t, acc, (g, touched) in zip(tables, accs, row_g):
                rowwise_adagrad(t, acc, touched, g, optim["learning_rate"], optim["eps"])
        out["losses"].append(float(loss.detach()))
    change = {f"dense.{k}": float((params[k] - flat0[k]).norm()) for k in params}
    change.update({f"field_{f}": float((t - r).norm()) for f, (t, r) in enumerate(zip(tables, rows0))})
    out["change_norms"] = change
    return out
