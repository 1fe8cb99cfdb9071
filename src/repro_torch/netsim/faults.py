"""Composable fault models applied at the COMM boundary.

The port of ``repro.netsim.faults``.  Faults act on what a gossip round
puts on the wire: which links carry a payload (an edge mask folded into
W_k), which nodes manage to send at all (a per-node send mask), and the
payload values themselves (bounded wire noise).  Link-level masking is
symmetric and the dropped weight moves onto both endpoints' diagonal
(``apply_edge_mask``), so the effective mixing matrix stays Assumption-1
compliant every round.

* ``Straggler`` -- a node skips its send for the round.  At the COMM
  boundary this is a *send mask*: the straggler's Q is dropped everywhere
  -- on the wire and in its own H update -- so every receiver falls back on
  its H state for that node (the paper's implicit error compensation folds
  the miss into the next round's difference).  For raw-iterate gossip
  (baselines mixing X directly) the same draw isolates the node in W_k.
* ``LinkDrop`` -- each edge independently loses its payload this round;
  the edge is renormalized out of W_k.
* ``NoisyChannel`` -- mean-zero noise bounded by sigma * ||q_i||_inf on the
  wire payload (all receivers see the same corruption).  Unbiased, so it
  composes with the compressor's Assumption-2 constant (``effective_C``).

Randomness comes from a draw source (``core.draws``), never from keys: a
fault's :meth:`FaultModel.masks` makes the round's draw and returns both
views of it (for a stacked grid's P points at once from a ``StackedDraws``:
one draw call a point, each point's the call its serial run makes, then
the masks of all P formed together), :meth:`FaultModel.payload_draw` draws a leaf's noise and
:meth:`FaultModel.payload` applies it.  The netsim mixer
(``netsim.engine.SimMixer``) draws each once per round (and leaf) and
keeps the draws for the round, so every reader of a round -- COMM,
raw-iterate gossip, the bits count -- sees the same draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import registry
from repro_torch.core.draws import Draws

Masks = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _with_unit_diagonal(alive: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(alive.shape[-1], dtype=torch.bool, device=alive.device)
    return alive.masked_fill(eye, 1.0)


class FaultModel:
    """Base: no-op fault.  Subclasses override the hooks below."""
    name: str = "fault"
    #: True -> at the COMM boundary this fault acts through its send mask
    #: (its edge mask is only for raw-iterate gossip)
    comm_via_send: bool = False

    def masks(self, draws: Draws, n: int, device, points: int = 0) -> Masks:
        """One round's draw -> (edge mask, send mask): an (n, n) symmetric
        f32 {0,1} mask of the links alive (diagonal 1) and an (n,) f32
        {0,1} mask of the nodes whose send succeeds, each None when the
        fault does not act that way.  Draws nothing when both are None.
        ``points`` > 0: ``draws`` is a ``StackedDraws`` of the points'
        sources and the masks are (P, n, n) and (P, n)."""
        return None, None

    def payload_draw(self, q: torch.Tensor, draws: Draws
                     ) -> Optional[torch.Tensor]:
        """The round's draw for one leaf's payload ``q``, or None (the
        fault leaves payloads alone and draws nothing)."""
        return None

    def payload(self, q: torch.Tensor, noise: Optional[torch.Tensor],
                node_axis: int = 0) -> torch.Tensor:
        """Corrupt the wire payload of one leaf (its node axis leading, or
        behind a stacked grid's point axis) with the round's draw from
        :meth:`payload_draw`."""
        return q

    def mean_edge_survival(self) -> float:
        """Expected fraction of directed edges carrying a payload."""
        return 1.0

    def effective_C(self, C: float, dim: int) -> float:
        """Assumption-2 constant of (this fault o compressor-with-C)."""
        return C


@registry.register_fault("linkdrop")
@dataclasses.dataclass(frozen=True)
class LinkDrop(FaultModel):
    """Each edge independently drops its payload with probability ``rate``;
    the row/column of W_k renormalizes via the diagonal.  Draws an (n, n)
    f64 uniform a round, of which the strict upper triangle decides."""
    rate: float = 0.1
    name: str = "linkdrop"

    def masks(self, draws, n, device, points=0):
        lead = (points,) if points else ()
        u = draws.uniform(lead + (n, n), dtype=torch.float64).to(device)
        u = torch.triu(u, 1)
        u = u + u.transpose(-2, -1)                   # symmetric per edge
        keep = (u >= self.rate).to(torch.float32)
        return _with_unit_diagonal(keep), None

    def mean_edge_survival(self):
        return 1.0 - self.rate


@registry.register_fault("straggler")
@dataclasses.dataclass(frozen=True)
class Straggler(FaultModel):
    """Each node independently skips its send with probability ``rate``.

    COMM boundary: acts via the send mask (receivers reuse H, weights
    untouched).  Raw-iterate gossip: the same Bernoulli draw isolates the
    node in W_k (all its links renormalized out for the round)."""
    rate: float = 0.1
    name: str = "straggler"
    comm_via_send: bool = True

    def masks(self, draws, n, device, points=0):
        slow = draws.bernoulli(self.rate, (n,)).to(device)   # (P,) n
        alive = (~(slow.unsqueeze(-1) | slow.unsqueeze(-2))).to(torch.float32)
        return _with_unit_diagonal(alive), (~slow).to(torch.float32)

    def mean_edge_survival(self):
        return 1.0 - self.rate                        # sender-side failures


@registry.register_fault("noise")
@dataclasses.dataclass(frozen=True)
class NoisyChannel(FaultModel):
    """Mean-zero noise bounded by sigma * ||q_i||_inf on node i's payload:
    uniform on [-amp, amp] per element, drawn in q's dtype."""
    sigma: float = 0.01
    name: str = "noise"

    def payload_draw(self, q, draws):
        return draws.uniform(tuple(q.shape), dtype=q.dtype, low=-1.0,
                             high=1.0)

    def payload(self, q, noise, node_axis=0):
        axes = tuple(range(node_axis + 1, q.dim()))
        amp = self.sigma * q.abs().amax(dim=axes, keepdim=True)
        return q + amp * noise

    def effective_C(self, C, dim):
        # E||Q(x)+xi - x||^2 = C||x||^2 + E||xi||^2 (xi independent, mean
        # zero).  Per element Var(xi) = (sigma ||q||_inf)^2 / 3 and
        # ||q||_inf <= 2 ||x||_2 for any Assumption-2 quantizer with
        # per-block scale <= ||x||_inf, so E||xi||^2 <= (4/3) dim sigma^2
        # ||x||^2.  (Conservative.)
        return C + 4.0 * dim * self.sigma ** 2 / 3.0


def apply_edge_mask(W: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Drop masked edges of W and move their weight onto both endpoints'
    diagonal.  Preserves symmetry and double stochasticity exactly (row
    sums are untouched), so the renormalized W_k still satisfies
    Assumption 1.  Acts on the last two axes: a (P, n, n) mask (a stacked
    grid's, one a point) against an (n, n) W gives (P, n, n)."""
    n = W.shape[-1]
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    off = W * (1.0 - eye)
    kept = off * mask.to(W.dtype)
    corr = (off - kept).sum(dim=-1)
    return kept + torch.diag_embed(
        torch.diagonal(W, dim1=-2, dim2=-1) + corr)


def effective_C(faults: Sequence[FaultModel], C: float, dim: int) -> float:
    """Assumption-2 constant of the faulty channel stacked on a compressor."""
    for f in faults:
        C = f.effective_C(C, dim)
    return C


def mean_edge_survival(faults: Sequence[FaultModel]) -> float:
    frac = 1.0
    for f in faults:
        frac *= f.mean_edge_survival()
    return frac


def make_fault(spec: str) -> FaultModel:
    """Parse 'name[:param]' -- e.g. 'linkdrop:0.1', 'straggler:0.05',
    'noise:0.01'; the positional argument maps onto the factory's first
    field (rate for linkdrop/straggler, sigma for noise)."""
    name, _, arg = spec.partition(":")
    kw = {}
    if arg:
        kw[registry.accepts("fault", name)[0]] = float(arg)
    return registry.make("fault", name, **kw)


def make_faults(specs: str) -> tuple:
    """Comma-separated fault specs -> tuple of FaultModel ('' -> ())."""
    return tuple(make_fault(s) for s in specs.split(",") if s.strip())
