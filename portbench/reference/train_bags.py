"""The reference's first training steps of a CTR family with multi-hot bags:
plain float32 PyTorch over the rows the steps touch, from the same initial
weights, the global batch taken in blocks of rows so that it fits one card.

Each table is held compact, as in ``reference/train.py``: the rows that the
compared steps' ids reach, regenerated from the seed by the benchmark, the
ids renumbered into them. A field's bag pools by the sum of its rows. The
loss is the global batch's mean, each block's share summed; the dense
params follow Adam, the rows rowwise Adagrad, each row's gradient summed
over every place its id takes in the batch. That sum is taken in float64
and rounded once to float32: a hot id's row gathers 10^5 gradients a step,
and a float32 running sum of them drifts by 10^-4 of itself. Every norm is
taken in float64: a float32 sum of a table's squares loses its small rows
under its hot ones.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from portbench.reference.common import Adam, leaves, matmul_for, rebuild, rowwise_adagrad

BLOCK_ROWS = 8192  # examples a block of the global batch


def train_steps_bags(logits: Callable, dense0, rows0: List[torch.Tensor], batches: List[dict],
                     widths: Sequence[int], optim: dict, precision: str = "float32",
                     drop_last_of: int | None = None, block_rows: int = BLOCK_ROWS) -> dict:
    """``batches``: {"cat": [B, sum W] int64, each field's bag side by side
    as compact rows of its table, "dense", "label"}. -> {"losses": [...],
    "grad_norms": {leaf: float} of the first step's gradient,
    "change_norms": {leaf: float} after the last step}; leaves
    "dense.<path>" and "field_<t>". ``precision``: "float32", "tf32"
    (every product's operands rounded to TF32), or "float64" (the same
    steps with every value in float64: what the float32 steps approximate,
    for the calibration's record). ``drop_last_of``: every bag of that
    width loses its last id (a fault the check must see)."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    mm = matmul_for("float32" if precision == "float64" else precision)
    flat0 = {k: v.to(dtype) for k, v in leaves(dense0).items()}
    dense0 = rebuild(dense0, flat0)
    params = {k: v.clone() for k, v in flat0.items()}
    rows0 = [r.to(dtype) for r in rows0]
    tables = [r.clone() for r in rows0]
    accs = [torch.zeros(r.shape[0], dtype=dtype, device=r.device) for r in rows0]
    adam = Adam(params, optim["learning_rate"], optim["adam_b1"], optim["adam_b2"], optim["eps"])
    offsets = [sum(widths[:f]) for f in range(len(widths))]
    out: Dict[str, object] = {"losses": []}
    for s, b in enumerate(batches):
        n = b["label"].shape[0]
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        dense_g = {k: torch.zeros_like(v) for k, v in params.items()}
        row_g = [torch.zeros(t.shape, dtype=torch.float64, device=t.device) for t in tables]
        touched = [torch.zeros(t.shape[0], dtype=torch.bool, device=t.device) for t in tables]
        loss_sum = torch.zeros((), dtype=dtype, device=tables[0].device)
        for r0 in range(0, n, block_rows):
            r1 = min(n, r0 + block_rows)
            bags = []
            for f, (off, w) in enumerate(zip(offsets, widths)):
                ids = b["cat"][r0:r1, off:off + w]
                bags.append(ids[:, :-1] if w == drop_last_of else ids)
            emb = torch.stack([t[ids].sum(dim=1) for t, ids in zip(tables, bags)], dim=1).requires_grad_()
            z = logits(rebuild(dense0, p), emb, b["dense"][r0:r1].to(dtype), mm)
            loss = torch.nn.functional.binary_cross_entropy_with_logits(
                z, b["label"][r0:r1].to(dtype), reduction="sum") / n
            grads = torch.autograd.grad(loss, [*p.values(), emb])
            for k, g in zip(p, grads[:-1]):
                dense_g[k] += g
            for f, ids in enumerate(bags):
                g = grads[-1][:, f, None, :].expand(-1, ids.shape[1], -1)
                row_g[f].index_add_(0, ids.reshape(-1), g.reshape(-1, g.shape[-1]).double())
                touched[f][ids.reshape(-1)] = True
            loss_sum += loss.detach()
        row_g = [g.to(dtype) for g in row_g]
        if s == 0:
            norms = {f"dense.{k}": float(g.double().norm()) for k, g in dense_g.items()}
            norms.update({f"field_{f}": float(g.double().norm()) for f, g in enumerate(row_g)})
            out["grad_norms"] = norms
        params = {k: v.detach() for k, v in adam.step(params, dense_g).items()}
        with torch.no_grad():
            for t, acc, g, hit in zip(tables, accs, row_g, touched):
                rowwise_adagrad(t, acc, hit, g, optim["learning_rate"], optim["eps"])
        out["losses"].append(float(loss_sum))
    change = {f"dense.{k}": float((params[k].double() - flat0[k].double()).norm()) for k in params}
    change.update({f"field_{f}": float((t.double() - r.double()).norm()) for f, (t, r) in enumerate(zip(tables, rows0))})
    out["change_norms"] = change
    return out
