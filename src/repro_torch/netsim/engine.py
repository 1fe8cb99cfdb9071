"""Scenario engine: decentralized algorithms under time-varying topologies
with injected communication faults.

The port of ``repro.netsim.engine``.  ``simulate`` wraps any stacked-state
algorithm -- Prox-LEAD / LEAD / NIDS or any ``core.baselines`` Baseline --
by swapping its mixer for a :class:`SimMixer` (W_k from a
:class:`TopologySchedule`, fault masks and wire noise from a draw source of
their own), then runs the steps in a Python loop, recording each step's
consensus error, objective and exact bits on the wire.  The records stay
on the device and reach the host once, after the last step.

Two COMM semantics, chosen by the mixer (``recompute_hw``):

* static W, no faults -- the paper's incremental recursion
  Zhat_w = Hw + W Q, bit for bit the DenseMixer path.
* time-varying W_k or faults -- Zhat_w = W_k (H + Q) recomputed from the
  receiver-side H replicas (the incremental recursion only tracks W H for
  a static W; under a varying W_k it accumulates a history-dependent bias).

Fault draws.  The reference derives a round's fault randomness from keys,
``fold_in(fold_in(key(fault_seed), k), i)`` (and ``fold_in(., 1 + leaf)``
for wire noise), and derives it again wherever it needs it.  The port's
draws are a stream, so a :class:`SimMixer` draws each round once and keeps
it: the masks of every fault, in fault order, at the round's first use,
then each (fault, leaf) noise at its first use.  Every reader of the round
-- COMM, raw-iterate gossip, the bits record -- sees the same arrays, as
the reference's re-derivations do.  Rounds are drawn in increasing order
(round None counts as 0); asking for an earlier round than the current one
raises.

A stacked grid (``repro_torch.sweep``, ``batch='vmap'``) runs one SimMixer
over every point (``SimMixer.stacked``): the schedule is shared, the
leaves carry a leading point axis, and each point's faults draw from its
own source -- one draw call a point and fault, the masks of the P points
then formed together, (P, n, n) and (P, n); each leaf's noise drawn point
by point into one (P, n, ...) array.  Each point's source sees the calls
of its serial run, in its order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.comm import acc_dtype, mix_with
from repro_torch.core.draws import Draws, GeneratorDraws, StackedDraws
from repro_torch.core.prox_lead import ProxLEAD
from repro_torch.netsim import faults as faults_mod
from repro_torch.netsim import metrics as metrics_mod
from repro_torch.netsim.schedule import ScheduledMixer, TopologySchedule
from repro_torch.obs.meters import current_meters
from repro_torch.tree import flatten, leaves, tree_map, unflatten


class SimMixer(ScheduledMixer):
    """ScheduledMixer + fault injection at the COMM boundary.

    Per round k: link faults renormalize W[k % T], straggler sends are
    masked, and each leaf's wire payload runs through the faults'
    ``payload`` hook.  The self term (Zhat = H + Q) never passes through
    the channel.  ``fault_draws`` is the faults' own draw source; a mixer
    serves one run, so a run that starts again from round 0 needs a new
    mixer over a new source.  ``mask_log``, when a list, receives (k, COMM
    edge mask, send mask) for every round drawn.  ``points`` > 0: the
    mixer of a stacked grid (see the module docstring), ``fault_draws`` a
    :class:`StackedDraws` of the points' fault sources."""

    def __init__(self, schedule: TopologySchedule,
                 faults: Sequence[faults_mod.FaultModel],
                 fault_draws: Draws, points: int = 0):
        super().__init__(schedule, node_axis=1 if points else 0)
        self.faults = tuple(faults)
        self.fault_draws = fault_draws
        self.points = int(points)
        uniform = all(np.array_equal(schedule.W_stack[t], schedule.W_stack[0])
                      for t in range(schedule.T_cycle))
        # static-and-clean keeps the paper's incremental Hw recursion
        # (bit for bit with DenseMixer); anything else recomputes W_k(H+Q)
        self.recompute_hw = bool(self.faults) or not uniform
        self.mask_log: Optional[List] = None
        self._k: Optional[int] = None
        self._masks: List[faults_mod.Masks] = []
        self._noise: Dict[Tuple[int, int], torch.Tensor] = {}

    @classmethod
    def stacked(cls, mixers: Sequence["SimMixer"]) -> "SimMixer":
        """One mixer over the points of ``mixers`` (one a point, each past
        its point's serial init): each point's fault stream continues from
        its own mixer, whose current round (an init may have drawn round
        0) is stacked and kept."""
        m0 = mixers[0]
        out = cls(m0.schedule, m0.faults,
                  StackedDraws([m.fault_draws for m in mixers]),
                  points=len(mixers))
        out._k = m0._k
        out._masks = [_stack_masks([m._masks[i] for m in mixers])
                      for i in range(len(m0._masks))]
        out._noise = {key: None if v is None else torch.stack(
                          [m._noise[key] for m in mixers])
                      for key, v in m0._noise.items()}
        return out

    # --- the round's draws, made once --------------------------------------
    def _round(self, k, device) -> List[faults_mod.Masks]:
        """The masks of round k (None means 0), drawn at its first use."""
        k = 0 if k is None else int(k)
        if self._k is not None and k < self._k:
            raise ValueError(f"round {k} was asked for after round "
                             f"{self._k}; a round's faults are drawn once, "
                             f"in increasing round order")
        if k != self._k:
            draws = self.fault_draws
            dev = device if device is not None else draws.device
            self._k, self._noise = k, {}
            self._masks = [f.masks(draws, self.schedule.n, dev, self.points)
                           for f in self.faults]
            if self.mask_log is not None:
                self.mask_log.append((k, self._edge(True), self._send()))
        return self._masks

    def _edge(self, comm: bool) -> Optional[torch.Tensor]:
        mask = None
        for f, (edge, _) in zip(self.faults, self._masks):
            if edge is None or (comm and f.comm_via_send):
                continue
            mask = edge if mask is None else mask * edge
        return mask

    def _send(self) -> Optional[torch.Tensor]:
        mask = None
        for _, send in self._masks:
            if send is not None:
                mask = send if mask is None else mask * send
        return mask

    def edge_mask_at(self, k, comm: bool, device=None
                     ) -> Optional[torch.Tensor]:
        """Combined symmetric link mask for round k, or None.  In COMM
        context stragglers act via ``send_mask`` instead (their edge mask
        is the raw-iterate-gossip view)."""
        if not self.faults:
            return None
        self._round(k, device)
        return self._edge(comm)

    def send_mask(self, k=None, device=None) -> Optional[torch.Tensor]:
        if not self.faults:
            return None
        self._round(k, device)
        return self._send()

    def _wire(self, q: torch.Tensor, k, leaf_idx: int) -> torch.Tensor:
        if not self.faults:
            return q
        self._round(k, q.device)
        for i, f in enumerate(self.faults):
            if (i, leaf_idx) not in self._noise:
                self._noise[i, leaf_idx] = f.payload_draw(
                    q, self.fault_draws)
            q = f.payload(q, self._noise[i, leaf_idx], self.node_axis)
        return q

    def _W(self, k, dtype, device, mask):
        W = self.W_k(k, dtype, device)
        if mask is not None:
            W = faults_mod.apply_edge_mask(W, mask)
        return W

    # --- COMM-boundary channel (used when recompute_hw) -------------------
    def comm_W(self, k, dtype, device) -> torch.Tensor:
        """W_k through the round's COMM link faults."""
        return self._W(k, dtype, device, self.edge_mask_at(k, True, device))

    def comm_payload(self, h, q, k=None, leaf_idx=0) -> torch.Tensor:
        """What W_k mixes at the COMM boundary: H + Q through the channel,
        in the mixing dtype."""
        acc = acc_dtype(h.dtype)
        return h.to(acc) + self._wire(q.to(acc), k, leaf_idx)

    def comm_mix(self, h, q, k=None, leaf_idx=0):
        W = self.comm_W(k, acc_dtype(h.dtype), h.device)
        return mix_with(W, self.comm_payload(h, q, k, leaf_idx),
                        self.node_axis).to(h.dtype)

    # --- raw-iterate gossip (baselines mixing X / xhat directly) ----------
    def __call__(self, X, k=None):
        if not self.faults:
            return super().__call__(X, k)
        leaves, treedef = flatten(X)
        out = []
        for j, leaf in enumerate(leaves):
            acc = acc_dtype(leaf.dtype)
            W = self._W(k, acc, leaf.device,
                        self.edge_mask_at(k, False, leaf.device))
            q = self._wire(leaf.to(acc), k, j)
            out.append(mix_with(W, q, self.node_axis).to(leaf.dtype))
        return unflatten(treedef, out)


def _stack_masks(per_point: Sequence[faults_mod.Masks]) -> faults_mod.Masks:
    """The points' (edge, send) masks of one fault, each stacked on a
    leading point axis (None stays None)."""
    return tuple(None if per_point[0][j] is None
                 else torch.stack([m[j] for m in per_point])
                 for j in range(2))


def _support_stack(schedule: TopologySchedule, device) -> torch.Tensor:
    """(T, n, n) bool: off-diagonal support of each W_k.  Entry (i, j) is
    the directed payload j -> i."""
    supp = np.abs(schedule.W_stack) > 1e-12
    supp &= ~np.eye(schedule.n, dtype=bool)
    return torch.as_tensor(supp, device=device)


def make_step_record(algo, mixer: SimMixer, schedule: TopologySchedule, *,
                     device, objective_fn: Optional[Callable] = None,
                     bits_per_edge: int = 0) -> Callable:
    """The per-step body of :func:`simulate`: ``step(state, draws) ->
    (new state, record)``, one algorithm step plus its record -- consensus
    error, objective (0 without ``objective_fn``) and the exact bits on
    the wire (int64: payload bits per directed edge times the directed
    edges that carried one).  Every record entry is a 0-d tensor on the
    device; nothing waits for it.  ``algo`` must already carry ``mixer``.

    Over a stacked grid's mixer (``mixer.points`` = P) every entry is (P,),
    one a point: ``bits_per_edge`` is then a (P,) int64 tensor (each
    point's compressor prices its payload) and ``objective_fn`` takes one
    point's X."""
    supp = _support_stack(schedule, device)
    T = schedule.T_cycle
    comm_style = isinstance(algo, ProxLEAD)
    P = mixer.points
    zero = torch.zeros((P,) if P else (), dtype=torch.float64, device=device)

    def objective(X):
        if objective_fn is None:
            return zero
        if not P:
            return objective_fn(X)
        return torch.stack([objective_fn(tree_map(lambda l: l[i], X))
                            for i in range(P)])

    def step(state, draws):
        k = state.k                       # round index the step will use
        new = algo.step(state, draws)
        alive = supp[k % T]               # (n, n), or (P, n, n) when masked
        emask = mixer.edge_mask_at(k, comm=comm_style, device=device)
        if emask is not None:
            alive = alive & (emask > 0)
        if comm_style:
            send = mixer.send_mask(k, device=device)
            if send is not None:          # sender is the column
                alive = alive & (send.unsqueeze(-2) > 0)
        bits = alive.sum((-2, -1)) * bits_per_edge
        rec = (metrics_mod.consensus_error(new.X, 1 if P else 0),
               objective(new.X), bits)
        return new, rec

    return step


def simulate(algo, schedule: TopologySchedule,
             faults: Sequence[faults_mod.FaultModel] = (), *,
             X0, steps: int, seed: int = 0, fault_seed: int = 0,
             objective_fn: Optional[Callable] = None,
             draws: Optional[Draws] = None,
             fault_draws: Optional[Draws] = None,
             mask_log: Optional[List] = None
             ) -> Tuple[object, metrics_mod.Trajectory]:
    """Run ``algo`` for ``steps`` iterations under ``schedule`` + ``faults``.

    ``algo`` is any dataclass with a ``mixer`` field and ``init(X0,
    draws)`` / ``step(state, draws)`` methods whose state carries a host
    int ``.k`` and stacked ``.X`` (ProxLEAD and every Baseline qualify);
    its mixer is replaced by a SimMixer, nothing else changes.  The
    algorithm draws from ``draws`` (default: a generator seeded ``seed``
    on X0's device), the faults from ``fault_draws`` (default: seeded
    ``fault_seed``), two separate streams.  ``mask_log``: see SimMixer.

    Returns (final_state, Trajectory) with per-iteration consensus error,
    objective (``objective_fn(X)``; 0.0 if None) and exact bits on the
    wire: payload bits per directed edge times the directed edges that
    actually carried one that round (straggler sends and dropped links
    excluded -- read from the masks the mixer drew for the round).
    """
    device = leaves(X0)[0].device
    if draws is None:
        draws = GeneratorDraws(seed, device)
    if fault_draws is None:
        fault_draws = GeneratorDraws(fault_seed, device)
    mixer = SimMixer(schedule, faults, fault_draws)
    mixer.mask_log = mask_log
    algo = dataclasses.replace(algo, mixer=mixer)
    bits_per_edge = metrics_mod.payload_bits_per_node(
        getattr(algo, "compressor", None), X0)
    step = make_step_record(algo, mixer, schedule, device=device,
                            objective_fn=objective_fn,
                            bits_per_edge=bits_per_edge)
    m = current_meters()
    if m is not None:
        m.set("netsim/bits_per_edge_per_round", bits_per_edge)
        m.set("netsim/steps", steps)
        m.set("netsim/n_nodes", schedule.n)
    state = algo.init(X0, draws)
    recs = []
    for _ in range(steps):
        state, rec = step(state, draws)
        recs.append(rec)
    if recs:                              # one copy to the host, at the end
        cons, obj, bits = (torch.stack(c).cpu() for c in zip(*recs))
    else:
        cons = obj = bits = torch.zeros(0, dtype=torch.float64)
    traj = metrics_mod.Trajectory(
        consensus=cons.to(torch.float64).numpy(),
        objective=obj.to(torch.float64).numpy(),
        bits=bits.numpy().astype(np.int64),
        meta={"schedule": schedule.name, "T_cycle": schedule.T_cycle,
              "faults": [f.name for f in faults],
              "joint_spectral_gap": schedule.joint_spectral_gap(),
              "bits_per_edge_per_round": bits_per_edge,
              "algo": getattr(algo, "name", type(algo).__name__)})
    return state, traj
