"""The comparison that decides ``correct``.

The program's first steps (the cell's ``checked_steps``, taken in set-up
through the window's own call on the window's own batches and noise) are
held against the plain reference following the same steps from the same
weights, batches and uniforms.  The numbers compared:

  loss_gap    the widest relative gap of a step's mean loss
  grad_gap    the first step's gradient, node by node and leaf by leaf:
              the widest gap between the program's norm and the
              reference's, over the reference's norm of that leaf or of
              the median leaf, whichever is larger
  change_gap  the same of ||X - X_0|| after the checked steps, over the
              leaves whose reference gradient is not nought to rounding
              (at least MOVED_SHARE of the median leaf's: a key bias
              under the softmax moves by round-off alone)
  l1_gap      the same of ||X||_1 after the checked steps: the l1 prox
              moves every element eta lam a step towards nought, which
              moves this norm at first order (||X - X_0|| is the
              compression noise, which hides it)
  state_gap   the same of ||D||, ||H|| and each Hw slot's norm after the
              checked steps (the widest of them): the rest of the state
  bits_gap    the bits a node sends in a step against the reference's
              count of the payload (exact)

A readout is a dict: ``losses`` [steps], ``grad_norms``,
``change_norms`` and ``l1_norms`` (nodes, leaves) tensors,
``state_norms`` a list of them (D, H, then each Hw slot), ``bits`` an
int.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "l1_gap", "state_gap",
           "bits_gap")
#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of ``change_gap``
MOVED_SHARE = 1e-3


def _leafwise_all(p: torch.Tensor, r: torch.Tensor, keep=None
                  ) -> torch.Tensor:
    """Each (node, leaf)'s gap over max(its norm, the median norm); the
    leaves outside ``keep`` read 0."""
    p, r = p.double().cpu(), r.double().cpu()
    keep = torch.ones_like(r, dtype=torch.bool) if keep is None else keep
    floor = r[keep].median()
    return torch.where(keep, (p - r).abs() / torch.maximum(r, floor), 0.0)


def _leafwise(p: torch.Tensor, r: torch.Tensor, keep=None) -> float:
    return float(_leafwise_all(p, r, keep).max())


def _moved(ref: dict) -> torch.Tensor:
    g = ref["grad_norms"].double().cpu()
    return g >= MOVED_SHARE * g.median()


def worst(prog: dict, ref: dict, key: str) -> Tuple[int, int]:
    """(node, leaf) of the widest gap of the norms under ``key``."""
    gap = _leafwise_all(prog[key], ref[key], _moved(ref))
    i = int(gap.argmax())
    return divmod(i, gap.shape[1])


def state_gaps(prog: dict, ref: dict) -> List[float]:
    """The gap of each part of the state: D, H, then each Hw slot."""
    if len(prog["state_norms"]) != len(ref["state_norms"]):
        raise ValueError(f"{len(prog['state_norms'])} state parts against "
                         f"the reference's {len(ref['state_norms'])}")
    moved = _moved(ref)
    return [_leafwise(p, r, moved)
            for p, r in zip(prog["state_norms"], ref["state_norms"])]


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of ``prog`` against ``ref``."""
    loss = float(torch.tensor([abs(float(a) - float(b)) / abs(float(b))
                               for a, b in zip(prog["losses"],
                                               ref["losses"])]).max())
    moved = _moved(ref)
    return {"loss_gap": loss,
            "grad_gap": _leafwise(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": _leafwise(prog["change_norms"],
                                    ref["change_norms"], moved),
            "l1_gap": _leafwise(prog["l1_norms"], ref["l1_norms"], moved),
            "state_gap": max(state_gaps(prog, ref)),
            "bits_gap": float(abs(int(prog["bits"]) - int(ref["bits"])))}


def judge(found: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[str], Dict[str, dict]]:
    """(correct, one stderr line a number, the result line's entry): a
    number is within its limit when it is not above it (NaN never is)."""
    ok, lines, entry = True, [], {}
    for name in NUMBERS:
        v, lim = found[name], limits[name]
        good = v <= lim
        ok &= good
        lines.append(f"{name} {v!r} limit {lim!r} {'ok' if good else 'FAIL'}")
        entry[name] = {"value": v, "limit": lim}
    return ok, lines, entry
