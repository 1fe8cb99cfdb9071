"""State checkpoints: an npz payload and a json manifest a step.

The port of ``repro.checkpoint.ckpt``, in its on-disk format:
``<path>/ckpt_<step>.npz`` holds leaf i as ``a<i>`` and
``<path>/manifest_<step>.json`` the leaves' ``keys``, ``dtypes`` and
``shapes`` and an ``extra`` dict (runners embed their spec there, see
``repro_torch.api.load_checkpoint``).  A leaf's key is its path in the
state, the reference's spelling: ``.field`` for a NamedTuple field, the
key of a dict, the index of a list or tuple, joined by ``/`` (``.X``,
``.comm/.H``, ``.plead/.X/embed``).

The port's states hold more than tensors: a Python int (the iteration
``k``, a trainer's ``step``, the oracle's tag) is stored as a 0-d int64
array and restored as an int; ``None`` (an oracle without a reference
point, no preconditioner) as the reference's 0-d int32 placeholder and
restored as None -- so the reference's checkpoint of a state of one
structure has the same keys.  numpy has no bfloat16: such a leaf is stored
as its 16-bit pattern (uint16) with ``bfloat16`` in the manifest.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix: str, out: List[Tuple[str, Any]]) -> None:
    """(key, leaf) pairs of ``tree`` in order; a leaf is a tensor, an int
    or None."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: k)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            _items(getattr(tree, name), join(f".{name}"), out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _items(tree[k], join(str(k)), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _items(v, join(str(i)), out)
    else:
        out.append((prefix, tree))


def _rebuild(tree, leaves):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def items(state) -> List[Tuple[str, Any]]:
    """The (key, leaf) pairs a checkpoint of ``state`` holds, in order."""
    out: List[Tuple[str, Any]] = []
    _items(state, "", out)
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if leaf is None:
        return np.asarray(np.int32(0)), "int32"
    if isinstance(leaf, (bool, np.bool_)):
        raise TypeError("a bool leaf has no checkpoint form")
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(np.int64(leaf)), "int64"
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_state(path, state, step: int = 0,
               extra: Optional[dict] = None) -> pathlib.Path:
    """Write ``<path>/ckpt_<step>.npz`` and ``manifest_<step>.json``;
    returns the npz path.  Device tensors are copied to the host."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    pairs = [(k, _to_numpy(leaf)) for k, leaf in items(state)]
    npz = p / f"ckpt_{step}.npz"
    np.savez(npz, **{f"a{i}": a for i, (_, (a, _)) in enumerate(pairs)})
    manifest = {"step": step, "keys": [k for k, _ in pairs],
                "dtypes": [d for _, (_, d) in pairs],
                "shapes": [list(a.shape) for _, (a, _) in pairs],
                "extra": extra or {}}
    (p / f"manifest_{step}.json").write_text(json.dumps(manifest, indent=1))
    return npz


def load_manifest(path, step: int = 0) -> dict:
    """The json manifest of one checkpoint step (keys, dtypes, shapes,
    extra)."""
    return json.loads((pathlib.Path(path) / f"manifest_{step}.json")
                      .read_text())


def load_arrays(path, step: int = 0) -> dict:
    """A checkpoint's leaves as numpy arrays by key (a bfloat16 leaf as its
    uint16 pattern): what ``repro_torch.convert`` maps a reference
    checkpoint from."""
    manifest = load_manifest(path, step)
    with np.load(pathlib.Path(path) / f"ckpt_{step}.npz") as data:
        return {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}


def _restore(key: str, arr: np.ndarray, dtype: str, tmpl):
    if tmpl is None:
        if arr.ndim or not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{key}: the template holds None, the "
                             f"checkpoint a {dtype} {arr.shape} array")
        return None
    if isinstance(tmpl, int):
        if arr.ndim or not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{key}: the template holds an int, the "
                             f"checkpoint a {dtype} {arr.shape} array")
        return int(arr)
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(tmpl.shape)}")
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if t.dtype != tmpl.dtype:
        raise ValueError(f"{key}: dtype {t.dtype} != the template's "
                         f"{tmpl.dtype}")
    return t.to(tmpl.device)


def load_state(path, template, step: int = 0):
    """Restore a checkpoint into the structure of ``template`` (keys,
    shapes and dtypes checked; tensors land on the template's devices)."""
    manifest = load_manifest(path, step)
    pairs = items(template)
    if [k for k, _ in pairs] != manifest["keys"]:
        raise ValueError("checkpoint tree structure mismatch")
    arrays = load_arrays(path, step)
    leaves = iter([_restore(k, arrays[k], d, tmpl)
                   for (k, tmpl), d in zip(pairs, manifest["dtypes"])])
    return _rebuild(template, leaves)


def latest_step(path) -> Optional[int]:
    """The largest step with a manifest under ``path``, or None."""
    steps = [int(f.stem.split("_")[1])
             for f in pathlib.Path(path).glob("manifest_*.json")]
    return max(steps) if steps else None
