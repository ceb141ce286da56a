"""Checkpoints in the JAX package's on-disk layout: the counterpart of
``tfrec_tpu/utils/checkpoint.py``, with numpy only.

``<dir>/step_<N:010d>/`` holds one ``.npy`` per leaf per process (suffix
``.p<i>``, named from the leaf's flat key), ``tree.json`` (``step``, the
sorted ``keys``, ``process_count``, ``device_count`` and any layout facts
passed as ``meta``) and each process's ``blocks.p<i>.json``, the global row
spans of its sharded leaves. A checkpoint here is a flat ``{key: array}``
mapping; the keys are JAX's pytree path strings (``"tables/field_0"``,
``"dense/mlp/0/0"``, ``"dense_opt/0/.mu/w_out"``), and ``convert`` maps the
port's train state to them and back.

On one device every leaf is whole (``blocks.p0.json`` is empty). On N
ranks (``parallel/``, one device a rank) each rank writes its ``.p<rank>``
blocks and their spans, the reference's multi-process layout: a row-sharded
leaf as its rows [rank * rps, (rank + 1) * rps) of the padded global array,
a replicated leaf whole with ``{"axis": null}``; rank 0 writes
``tree.json`` (``process_count`` and ``device_count`` N), and barriers
order the temporary directory's clean-up, the writes and rank 0's publish.
A checkpoint is restored from any topology, the port's or the JAX
package's: where the saving process or device count differs, each leaf is
reassembled from every process's blocks by their recorded spans, and pad
rows on axis 0 (the mesh path pads vocabularies to a multiple of the
device count; pad rows are zeros) are dropped or added to fit the
template. A row-permuted checkpoint (``mesh.row_permute``: the physical
row order is a function of the saving mesh's data axis) is read only by a
run that expects it over the same number of shards, as in the reference
(``expect_row_permute``, ``expect_row_permute_shards``).

The reference's orbax backend (``save_checkpoint_orbax``) is a JAX library
with no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Dict, Mapping, Sequence

import numpy as np

_STEP_DIR = re.compile(r"step_(\d+)")


def leaf_file(key: str) -> str:
    """The file stem of a flat key (the reference's, ``.p<i>.npy`` follows)."""
    return re.sub(r"[^\w/.-]", "_", key).replace("/", "__")


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save_checkpoint(ckpt_dir: str, step: int, flat: Mapping[str, np.ndarray], keep: int = 3,
                    meta: dict | None = None, mesh=None, spans: Mapping[str, dict] | None = None
                    ) -> str:
    """Write ``flat`` as checkpoint ``step`` and return its directory. The
    files go to ``step_<N>.tmp`` first (a stale one from a crashed save is
    removed), which then replaces any checkpoint of the same step; the
    newest ``keep`` checkpoints stay (all with ``keep <= 0``).

    On a ``mesh`` (``parallel.mesh.Mesh``) every rank calls this with its
    own ``flat`` blocks and their ``spans`` (``{key: {"axis", "spans",
    "global_shape"}}``, the reference's ``blocks.p<i>.json``); rank 0 alone
    cleans, writes ``tree.json``, publishes and prunes, between barriers."""
    out = step_dir(ckpt_dir, step)
    tmp = out + ".tmp"
    proc, count = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    if proc == 0 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    if mesh is not None:
        mesh.barrier()  # no rank writes into a stale tmp
    os.makedirs(tmp, exist_ok=True)
    for key, arr in flat.items():
        np.save(os.path.join(tmp, f"{leaf_file(key)}.p{proc}.npy"), np.asarray(arr))
    with open(os.path.join(tmp, f"blocks.p{proc}.json"), "w") as f:
        json.dump(dict(spans or {}), f)
    if proc == 0:
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(flat), "process_count": count,
                       "device_count": count, **(meta or {})}, f)
    if mesh is not None:
        mesh.barrier()  # every rank's blocks are in tmp
    if proc == 0:
        if os.path.exists(out):
            shutil.rmtree(out)
        os.replace(tmp, out)
        if keep > 0:
            for old in _steps(ckpt_dir)[:-keep]:
                shutil.rmtree(step_dir(ckpt_dir, old), ignore_errors=True)
    if mesh is not None:
        mesh.barrier()  # published before any rank goes on
    return out


def _steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := _STEP_DIR.fullmatch(d)))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def read_tree(ckpt_dir: str, step: int | None = None) -> dict:
    """A checkpoint's ``tree.json`` ({} when absent or unreadable)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return {}
    try:
        with open(os.path.join(step_dir(ckpt_dir, step), "tree.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def checkpoint_row_permute(ckpt_dir: str, step: int | None = None) -> bool:
    """Whether the tables were saved in the row-permuted physical layout."""
    return bool(read_tree(ckpt_dir, step).get("row_permute", False))


def checkpoint_table_layout(ckpt_dir: str, step: int | None = None) -> bool | None:
    """True when the saved CTR tables are lane-packed (``tables/pack_*``),
    False when per-field (``tables/field_*``), None when there is no
    checkpoint, no CTR table or no readable metadata."""
    for k in read_tree(ckpt_dir, step).get("keys", []):
        if k.startswith(("tables/pack_", "tables/linpack_")):
            return True
        if k.startswith(("tables/field_", "tables/lin_")):
            return False
    return None


def _blocks_meta(src: str) -> Dict[int, dict]:
    meta = {}
    for p in glob.glob(os.path.join(src, "blocks.p*.json")):
        with open(p) as f:
            meta[int(os.path.basename(p)[len("blocks.p"):-len(".json")])] = json.load(f)
    return meta


def _fit_axis0(arr: np.ndarray, want_shape: Sequence[int]) -> np.ndarray:
    """Absorb the pad rows on axis 0 that another device count adds (zeros
    by construction); any other mismatch, or dropping a non-zero row,
    raises."""
    want_shape = tuple(want_shape)
    if tuple(arr.shape) == want_shape:
        return arr
    if arr.ndim == 0 or arr.shape[1:] != want_shape[1:]:
        raise ValueError(
            f"checkpoint leaf shape {arr.shape} does not match template {want_shape} (only "
            "axis-0 pad-row differences are reconcilable)")
    want0 = want_shape[0]
    if arr.shape[0] > want0:
        if np.any(arr[want0:]):
            raise ValueError(
                f"cross-topology restore would truncate {arr.shape[0] - want0} NON-ZERO rows — "
                "the saved vocab exceeds the template's padded vocab; this is not a padding "
                "difference")
        return arr[:want0]
    pad = np.zeros((want0 - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _assemble_global(src: str, key: str, fname: str, blocks_meta: Dict[int, dict],
                     saved_procs) -> np.ndarray:
    """One leaf's global array from every saved process's block."""
    paths = {}
    for p in glob.glob(os.path.join(src, f"{fname}.p*.npy")):
        paths[int(os.path.basename(p).rsplit(".p", 2)[-1][: -len(".npy")])] = p
    if not paths:
        raise FileNotFoundError(f"{fname}.p*.npy missing under {src}")
    metas = {i: blocks_meta.get(i, {}).get(key) for i in paths}
    sharded = {i: m for i, m in metas.items() if m and m.get("axis") is not None}
    if not sharded:  # replicated or whole: every copy is the array
        return np.load(paths[min(paths)])
    first = sharded[min(sharded)]
    axis, gshape = first["axis"], tuple(first["global_shape"])
    sample = np.load(paths[min(sharded)])
    out = np.zeros(gshape, sample.dtype)
    filled = 0
    for i in sorted(sharded):
        arr = sample if i == min(sharded) else np.load(paths[i])
        off = 0
        for start, stop in sharded[i]["spans"]:
            n = stop - start
            dst = [slice(None)] * len(gshape)
            dst[axis] = slice(start, stop)
            take = [slice(None)] * len(gshape)
            take[axis] = slice(off, off + n)
            out[tuple(dst)] = arr[tuple(take)]
            off += n
            filled += n
    if filled < gshape[axis]:
        raise ValueError(
            f"checkpoint leaf {key!r}: saved blocks cover {filled} of {gshape[axis]} rows on axis "
            f"{axis} — incomplete checkpoint (found processes {sorted(paths)} of {saved_procs})")
    return out


def _check_row_permute(src: str, tree: dict, expect: bool, shards: int | None) -> None:
    """The reference's guards: a row-permuted checkpoint is read only by a
    run in the same permuted layout, over the same number of data shards."""
    saved = bool(tree.get("row_permute", False))
    if saved != expect:
        raise ValueError(
            f"checkpoint {src!r} was saved with row_permute={saved} but this run has "
            f"mesh.row_permute={expect}; the physical row layouts differ — restore with the "
            "matching config (a permuted checkpoint: on its mesh; or export/de-permute it first)")
    if not saved:
        return
    saved_shards = tree.get("row_permute_shards", tree.get("device_count"))
    if saved_shards is not None and shards is not None and saved_shards != shards:
        raise ValueError(
            f"checkpoint {src!r} was saved with row_permute=True over {saved_shards} data-axis "
            f"shards; this mesh has {shards} — the row layouts differ, restore at the saved "
            "shard count (or export/de-permute first)")


def restore_checkpoint(ckpt_dir: str, template: Mapping[str, Sequence[int]] | None = None,
                       step: int | None = None, expect_row_permute: bool = False,
                       expect_row_permute_shards: int | None = None) -> Dict[str, np.ndarray]:
    """The checkpoint at ``step`` (default: the latest) as ``{key: array}``
    in the saved (physical) row order.

    ``template`` maps the keys to restore to their shapes (every key the
    checkpoint lists without one). A checkpoint saved by one process on
    one device is read file for file, each leaf of its template's shape;
    one saved on another topology is reassembled from its blocks, each leaf
    fitted to its template shape on axis 0. Raises FileNotFoundError where
    there is no checkpoint or a leaf's file is missing, and ValueError for
    a leaf of another shape, or a row-permuted checkpoint unless
    ``expect_row_permute`` over ``expect_row_permute_shards`` shards (and a
    permuted run's expectation of a plain one)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = step_dir(ckpt_dir, step)
    tree = read_tree(ckpt_dir, step)
    _check_row_permute(src, tree, expect_row_permute, expect_row_permute_shards)
    keys = list(template) if template is not None else tree.get("keys", [])
    saved_procs, saved_devs = tree.get("process_count"), tree.get("device_count")
    same_topology = saved_procs is None or (saved_procs == 1 and saved_devs in (None, 1))
    blocks_meta = {} if same_topology else _blocks_meta(src)
    out = {}
    for key in keys:
        fname = leaf_file(key)
        if same_topology:
            path = os.path.join(src, f"{fname}.p0.npy")
            if not os.path.exists(path):
                raise FileNotFoundError(f"checkpoint leaf {key!r}: {path} is missing")
            out[key] = np.load(path)
            if template is not None and out[key].shape != tuple(template[key]):
                raise ValueError(f"checkpoint leaf {key!r} has shape {out[key].shape}; the "
                                 f"template's is {tuple(template[key])}")
            continue
        arr = _assemble_global(src, key, fname, blocks_meta, saved_procs)
        out[key] = arr if template is None else _fit_axis0(arr, template[key])
    return out


def load_table_arrays(ckpt_dir: str, step: int | None = None) -> Dict[str, np.ndarray]:
    """The embedding tables of a checkpoint, without a template: the warm
    start's loader (``train.init_from``). Returns ``{table name: array}``;
    a table sharded over processes is reassembled by its recorded spans (or,
    without spans, by axis-0 concatenation in process order, a replicated
    one kept once). Optimizer and dense state are not read."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise ValueError(f"no checkpoint found under {ckpt_dir!r}")
    d = step_dir(ckpt_dir, step)
    blocks_meta = _blocks_meta(d)
    per_name: Dict[str, Dict[int, str]] = {}
    for p in glob.glob(os.path.join(d, "tables__*.p*.npy")):
        name_part, proc = os.path.basename(p)[: -len(".npy")].rsplit(".p", 1)
        per_name.setdefault(name_part[len("tables__"):], {})[int(proc)] = p
    out: Dict[str, np.ndarray] = {}
    for name, procs in per_name.items():
        key = f"tables/{name}"
        if blocks_meta and any(key in m for m in blocks_meta.values()):
            out[name] = _assemble_global(d, key, f"tables__{name}", blocks_meta, len(procs))
            continue
        blocks = [np.load(procs[i]) for i in sorted(procs)]
        if len(blocks) > 1 and all(b.shape == blocks[0].shape and np.array_equal(b, blocks[0])
                                   for b in blocks[1:]):
            blocks = blocks[:1]  # a replicated leaf, saved by every process
        out[name] = blocks[0] if len(blocks) == 1 else np.concatenate(blocks, 0)
    return out
