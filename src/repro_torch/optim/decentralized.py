"""Prox-LEAD as the outer optimizer of decentralized NN training.

The port of ``repro.optim.decentralized``.  State layout: every parameter
leaf gains a leading node dim N -- node i's replica -- and all N nodes live
on one card.  The forward/backward runs every node at once (the node dim
is written out in each product); the Prox-LEAD update then gossips with
compression.

Gossip backends:
  dense    -- paper-faithful: ``ProxLEAD.update`` with QInf (kernels B1/B2)
              and W X as a contraction over the node dim (``DenseMixer``).
  neighbor -- wire-honest: the COMM exchange moves the PACKED b-bit
              payload (u8 codes + byte-cast scales) once per hop of the
              compiled ExchangePlan, through the ``pp(x, pairs)`` seam
              (:mod:`repro_torch.optim.wire`).  ``wire_mode='bucketed'``
              (default) moves two buffers per hop and runs kernels B3/B4;
              ``'per_leaf'`` is the parity oracle.  Identity compression
              moves raw leaves.
  ring     -- alias of neighbor.

Static schedules only (one Hw slot, T = 1): the time-varying schedules of
the neighbor backend, and fault injection on the dense one, arrive with
slice 3 (netsim).

Memory.  At the slice's full width (qwen3-1.7b, 8 nodes) one f32 state
copy is 5.7 GB and X, D, H, Hw together 23 GB, so the neighbor backend
updates D, H and Hw IN PLACE (the state handed to ``train_step`` is
consumed), writes the diffs straight into the bucket group's row table,
and frees each gradient leaf, the noise and the wire buffers as soon as
they are used.

The first trainer step folds Algorithm 1's warm-up (lines 1-3) into the
k=1 update with H^1 = 0, D^1 = 0, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import registry, tree
from repro_torch.core import bucket
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import CommState, DenseMixer
from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.draws import Draws
from repro_torch.core.oracles import OracleState
from repro_torch.core.prox import Prox
from repro_torch.core.prox_lead import ProxLEADState
from repro_torch.models import transformer as TR
from repro_torch.optim.wire import WIRE_MODES, WireExchange, stacked_pp

#: what a later slice of the port brings
NETSIM_SLICE = "slice 3 (ROADMAP A12: netsim schedules and faults)"


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The reference's TrainerConfig, less the fields that only a later
    slice reads (``repro_torch.api.LATER_TRAINER_FIELDS``)."""
    n_nodes: int
    eta: float = 1e-2
    alpha: float = 0.5
    gamma: float = 1.0
    compressor: str = "qinf"        # identity | qinf
    bits: int = 2
    block: int = 256
    prox: Optional[Prox] = None     # shared non-smooth regularizer
    topology: str = "ring"
    backend: str = "dense"          # dense | neighbor | ring (alias)
    schedule: str = "static"        # only static here (see module doc)
    pack_mode: str = "lastdim"      # lastdim | flat
    wire_mode: str = "bucketed"     # bucketed | per_leaf
    scales_bf16: bool = False
    aux_weight: float = 0.01
    precondition: str = "none"      # none | adam
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 0


class TrainState(NamedTuple):
    plead: ProxLEADState
    step: int
    # adam preconditioner moments ((m, v) trees) or None when unused
    precond: Any = None


class DecentralizedTrainer:
    def __init__(self, model_cfg: TR.ModelConfig, tcfg: TrainerConfig, *,
                 device, pp=None):
        self.mcfg = model_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        #: the exchange seam: ppermute semantics on node-stacked tensors
        self.pp = pp or stacked_pp
        self.topo = topo_mod.make_topology(tcfg.topology, tcfg.n_nodes)
        kw = registry.kwargs_subset(
            "compressor", tcfg.compressor,
            {"bits": tcfg.bits, "block": tcfg.block})
        self.compressor: Compressor = registry.make(
            "compressor", tcfg.compressor, **kw)
        self.prox = tcfg.prox or registry.make("prox", "none")
        self.plan: Optional[topo_mod.ExchangePlan] = None
        self.mixer = self._build_mixer()
        self.alg = registry.make(
            "algorithm", "prox_lead", eta=tcfg.eta, alpha=tcfg.alpha,
            gamma=tcfg.gamma, compressor=self.compressor, prox=self.prox,
            mixer=self.mixer, oracle=None)
        self._wmat = None
        if self.plan is not None:
            # (1 + n_hops, T, n): row 0 the exact-stochastic self weight,
            # then one row per hop -- receiver-indexed
            self._wmat = torch.as_tensor(np.concatenate(
                [self.plan.self_weights(np.float32)[None]]
                + [h.weights[None] for h in self.plan.hops], 0
            ).astype(np.float32), device=self.device)

    @property
    def sharded(self) -> bool:
        return self.tcfg.backend in ("ring", "neighbor")

    def _build_mixer(self):
        tcfg = self.tcfg
        if tcfg.backend not in ("dense", "neighbor", "ring"):
            raise ValueError(f"unknown backend {tcfg.backend!r}; have "
                             f"['dense', 'neighbor', 'ring']")
        if tcfg.schedule != "static":
            raise NotImplementedError(
                f"schedule {tcfg.schedule!r} is not ported yet: "
                f"time-varying schedules arrive with {NETSIM_SLICE}")
        if self.sharded:
            if tcfg.compressor not in ("identity", "qinf"):
                raise ValueError(
                    f"the neighbor backend packs QInf payloads; compressor "
                    f"{tcfg.compressor!r} needs backend='dense'")
            if tcfg.wire_mode not in WIRE_MODES:
                raise ValueError(f"unknown wire_mode {tcfg.wire_mode!r}; "
                                 f"have {WIRE_MODES}")
            self.plan = topo_mod.compile_plan(self.topo.W,
                                              name=self.topo.name)
        return DenseMixer(self.topo.W)

    # ------------------------------------------------------------------ init
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """One replica of freshly initialised parameters per node (drawn
        from ``generator``, default: seeded by ``tcfg.seed`` on the
        trainer's device)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.tcfg.seed)
        params = TR.init_params(self.mcfg, generator, self.device)
        N = self.tcfg.n_nodes
        X = tree.tree_map(lambda p: p[None].repeat((N,) + (1,) * p.dim()),
                          params)
        del params
        return self.state_from_stacked(X)

    def state_from_stacked(self, X) -> TrainState:
        zeros = lambda: tree.tree_map(torch.zeros_like, X)   # noqa: E731
        plead = ProxLEADState(X, zeros(), CommState(zeros(), zeros()),
                              OracleState(0, None, None), 1)
        precond = ((zeros(), zeros()) if self.tcfg.precondition == "adam"
                   else None)
        return TrainState(plead, 0, precond)

    # ------------------------------------------------------------------ loss
    def loss_and_grad(self, X, batch):
        """(mean node cross entropy, gradient of the SUM of node losses)."""
        leaves_X, treedef = tree.flatten(X)
        xs = [x.detach().requires_grad_(True) for x in leaves_X]
        with torch.enable_grad():
            logits, _, aux = TR.forward(self.mcfg,
                                        tree.unflatten(treedef, xs), batch)
            ces = TR.loss_fn(self.mcfg, logits, batch["labels"])
            del logits
            total = (ces + self.tcfg.aux_weight * aux).sum()
            grads = torch.autograd.grad(total, xs)
        return ces.detach().mean(), tree.unflatten(treedef, list(grads))

    # ------------------------------------------------------------------ step
    def train_step(self, state: TrainState, batch, draws: Draws
                   ) -> Tuple[TrainState, dict]:
        """One step; ``draws`` supplies the stochastic-rounding noise (one
        ``uniform`` per leaf, in leaf order).  Consumes ``state`` on the
        neighbor backend (D, H and Hw are updated in place)."""
        ce, G = self.loss_and_grad(state.plead.X, batch)
        precond = state.precond
        if self.tcfg.precondition == "adam":
            G, precond = self._adam_precondition(G, precond, state.step)
        if self.sharded:
            G = tree.leaves(G)
            plead = self._sharded_update(state.plead, G, draws)
        else:
            plead = self.alg.update(state.plead, G, draws)
        del G
        consensus = sum(((leaf - leaf.mean(0, keepdim=True)) ** 2).sum()
                        for leaf in tree.leaves(plead.X))
        metrics = {"loss": ce, "consensus": consensus, "step": state.step}
        return TrainState(plead, state.step + 1, precond), metrics

    def _adam_precondition(self, G, precond, step: int):
        """Beyond-paper: per-node Adam normalization of the gradient before
        the Prox-LEAD update.  Moments are local (never communicated)."""
        b1, b2, eps = self.tcfg.adam_b1, self.tcfg.adam_b2, self.tcfg.adam_eps
        m, v = precond
        m = tree.tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, m, G)
        v = tree.tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, v, G)
        t = torch.tensor(step + 1, dtype=torch.float32)
        c1 = float(1.0 / (1.0 - b1 ** t))
        c2 = float(1.0 / (1.0 - b2 ** t))
        Gp = tree.tree_map(
            lambda mm, vv: (mm * c1) / (torch.sqrt(vv * c2) + eps), m, v)
        return Gp, (m, v)

    # ---------------------------------------------------- neighbor backend
    def wire_layout(self) -> bucket.BucketLayout:
        """The bucketed wire layout of this model's parameters (per node,
        from their shapes alone)."""
        params = tree.leaves(TR.abstract_params(self.mcfg))
        return bucket.compute_layout(
            [(1,) + tuple(p.shape) for p in params],
            [p.dtype for p in params], bits=self.tcfg.bits,
            block_for=self._quant_block,
            scale_bytes=2 if self.tcfg.scales_bf16 else 4)

    def _quant_block(self, diff_shape) -> int:
        """Quantization block size for a per-node leaf shape: the
        configured block, never wider than an even last dim."""
        return bucket.default_quant_block(diff_shape, self.tcfg.block)

    def _sharded_update(self, plead: ProxLEADState, G, draws: Draws
                        ) -> ProxLEADState:
        """Lines 6-10 with the COMM exchange moving packed payloads once
        per hop of the compiled ExchangePlan (a node-stacked port of the
        reference's ``local_step``).  ``G`` is the list of gradient leaves
        in X's leaf order; each is freed once used."""
        tcfg = self.tcfg
        eta, alpha, gamma = tcfg.eta, tcfg.alpha, tcfg.gamma
        use_q = not isinstance(self.compressor, Identity)
        hop_pairs = [list(h.pairs) for h in self.plan.hops]
        leaves_X, treedef = tree.flatten(plead.X)
        D, H, Hw = (tree.leaves(t) for t in (plead.D, plead.comm.H,
                                             plead.comm.Hw))
        wx = WireExchange(bits=tcfg.bits, block=tcfg.block,
                          scales_bf16=tcfg.scales_bf16,
                          pack_mode=tcfg.pack_mode,
                          block_for=self._quant_block)
        rows = None
        if use_q and tcfg.wire_mode == "bucketed":
            layout = wx.layout(wx.local_shapes(leaves_X),
                               [x.dtype for x in leaves_X])
            rows = bucket.RowTables(layout, tcfg.n_nodes, self.device)
        zs, diffs = [], []
        for j, (x, d, h) in enumerate(zip(leaves_X, D, H)):
            z = x - eta * G[j] - eta * d
            G[j] = None
            if rows is None:
                diffs.append(z - h)
            else:                     # the diff lands in its group's rows
                rows.leaf_view(j).copy_(z - h)
            zs.append(z)
        # COMM: per leaf, the dequantized self payload and W Q
        if not use_q:
            wq, qs = wx.identity(diffs, self._wmat, hop_pairs, self.pp)
        elif rows is not None:
            wq, qs = wx.bucketed(rows, draws, self._wmat, hop_pairs, self.pp)
        else:
            wq, qs = wx.per_leaf(diffs, draws, self._wmat, hop_pairs,
                                 self.pp)
        del rows, diffs
        nX = []
        for j, (z, d, h, hw) in enumerate(zip(zs, D, H, Hw)):
            zhat = qs[j].add_(h)                  # h + Q_self
            zhat_w = wq[j][:, 0].add_(hw)         # Hw + (W Q), T = 1
            h.mul_(1 - alpha).add_(alpha * zhat)
            hw.mul_(1 - alpha).add_(alpha * zhat_w)
            e = zhat.sub_(zhat_w)                 # zhat - zhat_w
            d.add_(gamma / (2 * eta) * e)
            nX.append(self.prox(z.sub_(gamma / 2.0 * e), eta))
            zs[j] = qs[j] = wq[j] = None
        unf = lambda ls: tree.unflatten(treedef, ls)    # noqa: E731
        return ProxLEADState(unf(nX), plead.D,
                             CommState(plead.comm.H, plead.comm.Hw),
                             plead.oracle, plead.k + 1)
