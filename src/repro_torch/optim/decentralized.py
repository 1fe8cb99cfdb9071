"""Prox-LEAD as the outer optimizer of decentralized NN training.

The port of ``repro.optim.decentralized``.  State layout: every parameter
leaf gains a leading node dim N -- node i's replica -- and all N nodes live
on one card.  The forward/backward runs every node at once (the node dim
is written out in each product); the Prox-LEAD update then gossips with
compression.

Gossip backends:
  dense    -- paper-faithful: ``ProxLEAD.update`` with any registered
              compressor (QInf through kernels B1/B2, RandK, TopK with
              ``allow_biased``) and W X as a contraction over the node
              dim (``DenseMixer``); under a time-varying schedule or
              ``drop_rate`` (i.i.d. LinkDrop faults) a netsim ``SimMixer``
              with its own fault draws (seeded ``fault_seed``, started
              afresh with every fresh state).
  neighbor -- wire-honest: the COMM exchange moves the PACKED b-bit
              payload (u8 codes + byte-cast scales) once per hop of the
              compiled ExchangePlan, through the ``pp(x, pairs)`` seam
              (:mod:`repro_torch.optim.wire`).  ``wire_mode='bucketed'``
              (default) moves two buffers per hop and runs kernels B3/B4;
              ``'per_leaf'`` is the parity oracle.  Identity compression
              moves raw leaves.
  ring     -- alias of neighbor.

Time-varying schedules on the neighbor backend: payloads move over the
UNION support every round (a static hop set); per-round weight tables gate
the mixing.  Because the incremental recursion Hw + W Q only tracks W H
for a static W, the state keeps one Hw slot per schedule round t (leaf
shape (N, T, ...)): Hw[t] tracks W_t H via Hw[t] += alpha W_t Q -- every
union neighbour's Q arrives every round, and kernel B4 mixes all T rounds
in one launch -- and round k reads slot k % T.  Memory: T state copies.

Memory.  At the slice's full width (qwen3-1.7b, 8 nodes) one f32 state
copy is 5.7 GB and X, D, H, Hw together 23 GB, so the neighbor backend
updates D, H and Hw IN PLACE (the state handed to ``train_step`` is
consumed), writes the diffs straight into the bucket group's row table,
and frees each gradient leaf, the noise and the wire buffers as soon as
they are used.

Model-sharded meshes.  ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`)
of shape (N, M) shards each node's model over M devices in the
reference, and the neighbor backend runs inside ``shard_map``.  On the
JAX the reference is tested with (>= 0.6, where ``shard_map`` exists) the
per-leaf wire runs it partial-manual: whole leaves, one noise draw, the
model axis left to GSPMD -- so the port's per-leaf and identity wires run
as at (N, 1).  The bucketed wire runs full-manual: every model shard
quantizes, packs and moves its own model-local slice of each leaf
(``repro_torch.models.sharding``).  The port keeps a node's M shards in
one process, cuts each diff into them (:func:`sharding.shard_view`), runs
the bucketed exchange over N x M rows and updates the state through the
same views; a model-replicated leaf rides the wire M times with the same
bytes and noise, and its shard 0 updates the state (see
:mod:`repro_torch.optim.wire` for the draw rule).

Several processes.  With a :class:`repro_torch.launch.mesh.ProcessMesh`
the node axis splits over the ranks of a ``torch.distributed`` group:
rank r holds the node block [lo, hi), its state, data rows and weight
rows; the hops cross ranks through :class:`repro_torch.optim.wire.DistPP`;
the loss and consensus metrics are all-reduced (through the trainer's
``all_reduce`` seam, ``torch.distributed`` by default).  Each rank draws
the noise of its own rows.  Only the neighbor backend splits over ranks:
the dense backend mixes all N nodes with one (N, N) ``DenseMixer`` and is
refused with a process mesh (ROADMAP §A item 3 (d)).

A tensor-parallel node.  With a ``tp`` seam of M > 1 model ranks
(``repro_torch.models.tp``: ``StackedTP(M)`` in one process, ``DistTP``
over a :class:`repro_torch.launch.mesh.TPProcessMesh`, whose default
``tp`` it is) the state holds rank-rows, row ``n M + m`` = node n's model
shard m (a sharded leaf's model-local slice, a replicated leaf whole; a
DistTP rank holds model rank m's rows of its node block).  The forward
and backward split over the model ranks; each rank-row backpropagates its
copy of its node's loss, so every leaf's gradient is the node's, a
replicated leaf's bit-equal on the M ranks.  The update packs each
rank-row's own model-local leaves straight into the wire's rows (the
bucketed QInf wire only); the hops go to the same m of the neighbour
node; a replicated leaf's M copies, which draw the same noise, stay
bit-equal.  The loss is counted once a node, the consensus over the model
ranks with a replicated leaf counted once.  Refused at M > 1: the ssm and
hybrid families (ROADMAP §A item 3 (e)), the dense backend, the per-leaf
wire and identity compression.

Dry runs.  :meth:`DecentralizedTrainer.abstract_state` is a state of
``meta`` tensors; a trainer built on the ``meta`` device steps it with
:class:`repro_torch.core.draws.MetaDraws`, kernels B1-B4 taking the
card's route dry (``repro_torch.kernels.quantize``), nothing allocated
(``repro_torch.launch.dryrun``).

The first trainer step folds Algorithm 1's warm-up (lines 1-3) into the
k=1 update with H^1 = 0, D^1 = 0, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import registry, tree
from repro_torch.core import bucket
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import CommState, DenseMixer
from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.draws import Draws, draws_on
from repro_torch.core.oracles import OracleState
from repro_torch.core.prox import Prox
from repro_torch.core.prox_lead import ProxLEADState
from repro_torch.models import sharding
from repro_torch.models import tp as tp_mod
from repro_torch.models import transformer as TR
from repro_torch.netsim import SimMixer, make_schedule
from repro_torch.optim.wire import (WIRE_MODES, DistPP, WireExchange,
                                    stacked_pp)

#: B3/B4 pack and unpack codes of 1..7 bits (ROADMAP C10)
WIRE_MAX_BITS = 7


def dist_all_reduce(t: torch.Tensor, group) -> None:
    """The trainer's default metric all-reduce: ``torch.distributed``'s
    sum, in place, over ``group``."""
    import torch.distributed as dist
    dist.all_reduce(t, group=group)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The reference's TrainerConfig.  Refuses QInf above 7 bits on the
    neighbor backend (C10)."""
    n_nodes: int
    eta: float = 1e-2
    alpha: float = 0.5
    gamma: float = 1.0
    compressor: str = "qinf"        # identity | qinf | randk | topk
    bits: int = 2
    block: int = 256
    frac: float = 0.1               # randk / topk kept fraction
    allow_biased: bool = False      # opt-in for biased compressors (topk)
    prox: Optional[Prox] = None     # shared non-smooth regularizer
    topology: str = "ring"
    backend: str = "dense"          # dense | neighbor | ring (alias)
    # netsim scenario knobs: time-varying schedules run on both backends;
    # per-round fault injection (drop_rate) on the dense one only
    schedule: str = "static"        # static | alternating | random_matching
    #                               # | markov_drop
    schedule_rounds: int = 32       # T_cycle of the randomized schedules
    schedule_drop: float = 0.0      # markov_drop rate (schedule-level)
    drop_rate: float = 0.0          # i.i.d. LinkDrop fault rate
    fault_seed: int = 0
    pack_mode: str = "lastdim"      # lastdim | flat
    wire_mode: str = "bucketed"     # bucketed | per_leaf
    scales_bf16: bool = False
    shard_aligned_blocks: bool = False  # quantization blocks never cross
    tp_ways: int = 16               # a model shard of this many ways
    aux_weight: float = 0.01
    precondition: str = "none"      # none | adam
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 0

    def __post_init__(self):
        if (self.backend in ("neighbor", "ring") and self.compressor == "qinf"
                and self.bits > WIRE_MAX_BITS):
            raise ValueError(
                f"C10: QInf at {self.bits} bits cannot ride the neighbor "
                f"backend's wire, which packs 1..{WIRE_MAX_BITS}-bit codes: "
                f"at 8 bits a block's maximum takes code +128, whose offset "
                f"encoding (+128) is 256 and does not fit a byte -- the "
                f"reference's fused pack wraps it to byte 0, which decodes as "
                f"-128 (src/repro/kernels/quantize.py:106-110).  Use bits <= "
                f"{WIRE_MAX_BITS} or backend='dense'")


class TrainState(NamedTuple):
    plead: ProxLEADState
    step: int
    # adam preconditioner moments ((m, v) trees) or None when unused
    precond: Any = None


class DecentralizedTrainer:
    """``mesh``: the (N, M) mesh whose model axis M the bucketed wire cuts
    each node's leaves into (default: none, M = 1; the node count is
    ``tcfg.n_nodes`` whatever the mesh says).  ``process_mesh``: this
    rank's node block, when the nodes split over a process group (its
    ``pp`` defaults to :class:`DistPP`; the neighbor backend only).
    ``pp``: the exchange seam (default: the one-card :func:`stacked_pp`).
    ``tp``: the tensor-parallel seam (``repro_torch.models.tp``; default
    ``DistTP`` over a :class:`repro_torch.launch.mesh.TPProcessMesh`,
    else none: a node's products run whole).
    :attr:`all_reduce` ``(t, group)`` is the seam of the metrics' in-place
    sum over the process mesh's ranks (:func:`dist_all_reduce`; a dry run
    records it)."""

    def __init__(self, model_cfg: TR.ModelConfig, tcfg: TrainerConfig, *,
                 device, pp=None, mesh=None, process_mesh=None, tp=None):
        self.mcfg = model_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.process_mesh = process_mesh
        self.all_reduce = dist_all_reduce
        #: the node axis of this process (a TPProcessMesh's node_mesh)
        node_pm = getattr(process_mesh, "node_mesh", process_mesh)
        if tp is None:
            tp = (tp_mod.DistTP(process_mesh) if node_pm is not process_mesh
                  else tp_mod.NO_TP)
        #: the tensor-parallel seam
        self.tp = tp
        if process_mesh is not None:
            if tcfg.backend == "dense":
                raise ValueError(
                    "the dense backend does not split over ranks: it mixes "
                    "all N nodes with one (N, N) DenseMixer in one process "
                    "(a dense mixer over ranks is ROADMAP §A item 3 (d)); "
                    "use backend='neighbor' with a process_mesh, or no "
                    "process_mesh")
            if process_mesh.n_nodes != tcfg.n_nodes:
                raise ValueError(
                    f"process mesh over {process_mesh.n_nodes} nodes, "
                    f"trainer of {tcfg.n_nodes}")
            pp = pp or DistPP(node_pm)
        #: the exchange seam: ppermute semantics on node-stacked tensors
        self.pp = pp or stacked_pp
        #: nodes this process holds, from node ``node_lo`` on
        self.n_local = (node_pm.n_local if node_pm is not None
                        else tcfg.n_nodes)
        self.node_lo = node_pm.lo if node_pm is not None else 0
        paths = tree.flatten_with_paths(TR.abstract_params(model_cfg))
        #: per-node partition spec of every leaf, in leaf order
        self.leaf_specs = [sharding.spec_for_path(path, leaf.dim())
                           for path, leaf in paths]
        self.model_shards = sharding.model_axis_size(mesh)
        if tp.M > 1:
            self._check_tp(tp)
        self._layout: Optional[bucket.BucketLayout] = None
        sizes = {"model": self.model_shards}
        for (path, leaf), spec in zip(paths, self.leaf_specs):
            if not sharding.shard_dim_ok(leaf.shape, spec, sizes):
                raise ValueError(
                    f"leaf {path} {tuple(leaf.shape)} does not split into "
                    f"{self.model_shards} model shards along {spec}")
        self.topo = topo_mod.make_topology(tcfg.topology, tcfg.n_nodes)
        kw = registry.kwargs_subset(
            "compressor", tcfg.compressor,
            {"bits": tcfg.bits, "block": tcfg.block, "frac": tcfg.frac})
        self.compressor: Compressor = registry.make(
            "compressor", tcfg.compressor, **kw)
        self.prox = tcfg.prox or registry.make("prox", "none")
        self.plan: Optional[topo_mod.ExchangePlan] = None
        self.mixer = self._build_mixer()
        self.alg = registry.make(
            "algorithm", "prox_lead", eta=tcfg.eta, alpha=tcfg.alpha,
            gamma=tcfg.gamma, compressor=self.compressor, prox=self.prox,
            mixer=self.mixer, oracle=None, allow_biased=tcfg.allow_biased)
        self._wmat = None
        if self.plan is not None:
            # (1 + n_hops, T, n): row 0 the exact-stochastic self weight,
            # then one row per hop -- receiver-indexed, this process's
            # receivers
            lo = self.node_lo
            self._wmat = torch.as_tensor(np.concatenate(
                [self.plan.self_weights(np.float32)[None]]
                + [h.weights[None] for h in self.plan.hops], 0
            )[:, :, lo:lo + self.n_local].astype(np.float32),
                device=self.device)

    def _check_tp(self, tp) -> None:
        """What a tensor-parallel node refuses, at build."""
        tcfg, M = self.tcfg, tp.M
        tp_mod.refuse_family(self.mcfg.family, M, self.mcfg.name)
        if M != self.model_shards:
            raise ValueError(f"a tp seam of {M} model ranks on a mesh of "
                             f"{self.model_shards} model shards")
        if (tcfg.backend not in ("neighbor", "ring")
                or tcfg.wire_mode != "bucketed"
                or tcfg.compressor != "qinf"):
            raise ValueError(
                f"a tensor-parallel node (M = {M}) runs the neighbor "
                f"backend's bucketed QInf wire, each rank-row packing its "
                f"own model-local leaves; backend {tcfg.backend!r}, "
                f"wire_mode {tcfg.wire_mode!r}, compressor "
                f"{tcfg.compressor!r} mix whole leaves (the dense backend "
                f"over ranks is ROADMAP §A item 3 (d)); run them at M = 1")

    @property
    def sharded(self) -> bool:
        return self.tcfg.backend in ("ring", "neighbor")

    def _schedule(self):
        tcfg = self.tcfg
        kw = ({"drop": tcfg.schedule_drop}
              if tcfg.schedule == "markov_drop" else {})
        return make_schedule(tcfg.schedule, tcfg.n_nodes,
                             base=tcfg.topology, rounds=tcfg.schedule_rounds,
                             seed=tcfg.seed, **kw)

    def _build_mixer(self):
        tcfg = self.tcfg
        if tcfg.backend not in ("dense", "neighbor", "ring"):
            raise ValueError(f"unknown backend {tcfg.backend!r}; have "
                             f"['dense', 'neighbor', 'ring']")
        if self.sharded:
            if tcfg.drop_rate > 0:
                raise ValueError(
                    "netsim fault injection (drop_rate) needs "
                    "backend='dense'; the sharded neighbor path covers "
                    "time-varying schedules but not per-round edge faults")
            if tcfg.compressor not in ("identity", "qinf"):
                raise ValueError(
                    f"the sharded neighbor backend packs QInf payloads; "
                    f"compressor {tcfg.compressor!r} needs backend='dense'")
            if tcfg.wire_mode not in WIRE_MODES:
                raise ValueError(f"unknown wire_mode {tcfg.wire_mode!r}; "
                                 f"have {WIRE_MODES}")
            if tcfg.schedule != "static":
                sched = self._schedule()
                self.plan = topo_mod.compile_plan(sched.W_stack,
                                                  name=sched.name)
                if self.plan.T > 8:
                    warnings.warn(
                        f"neighbor backend keeps one Hw slot per schedule "
                        f"round: T={self.plan.T} multiplies the Hw state "
                        f"{self.plan.T}x (leaf (N, T, ...)).  Lower "
                        f"schedule_rounds or use backend='dense' if this "
                        f"does not fit memory.", stacklevel=3)
            else:
                self.plan = topo_mod.compile_plan(self.topo.W,
                                                  name=self.topo.name)
            # backs self.alg, which the neighbor path never steps
            return DenseMixer(self.topo.W)
        if tcfg.schedule == "static" and tcfg.drop_rate <= 0:
            return DenseMixer(self.topo.W)
        faults = ((registry.make("fault", "linkdrop", rate=tcfg.drop_rate),)
                  if tcfg.drop_rate > 0 else ())
        return SimMixer(self._schedule(), faults,
                        draws_on(tcfg.fault_seed, self.device))

    def start_fault_stream(self, fault_draws: Optional[Draws] = None
                           ) -> None:
        """Start the dense backend's fault stream afresh: a new SimMixer
        whose faults draw from ``fault_draws`` (default: a generator seeded
        ``tcfg.fault_seed`` on the trainer's device), its rounds drawn anew
        from the next one asked for.  ``state_from_stacked`` calls it, so
        every fresh state starts the stream at its first round.  A no-op
        without faults."""
        if not (isinstance(self.mixer, SimMixer) and self.mixer.faults):
            return
        if fault_draws is None:
            fault_draws = draws_on(self.tcfg.fault_seed, self.device)
        self.mixer = SimMixer(self.mixer.schedule, self.mixer.faults,
                              fault_draws)
        self.alg = dataclasses.replace(self.alg, mixer=self.mixer)

    @property
    def hw_slots(self) -> Optional[int]:
        """Hw slots a node keeps: T for a time-varying plan on the
        neighbor backend, else None (Hw shaped like H)."""
        if self.plan is not None and self.plan.T > 1:
            return self.plan.T
        return None

    # ------------------------------------------------------------------ init
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """One replica of freshly initialised parameters per node (drawn
        from ``generator``, default: seeded by ``tcfg.seed`` on the
        trainer's device); on a rank, the rows of its nodes (every rank
        seeds the same replica)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.tcfg.seed)
        params = TR.init_params(self.mcfg, generator, self.device)
        X = TR.stack_nodes(params, self.n_local)   # this process's rows
        del params
        return self.state_from_stacked(X)

    def state_from_stacked(self, X) -> TrainState:
        """A fresh state from ``X``, this process's node rows (n_local,
        ...) of every whole leaf (cut into rank-rows under a ``tp`` seam)."""
        self.start_fault_stream()
        return self._state_of(self.to_rank_rows(X))

    def to_rank_rows(self, X, lead: int = 1):
        """A tree of this process's node rows of whole leaves -> its
        rank-rows (the tree itself without a ``tp`` seam)."""
        if self.tp.M == 1:
            return X
        leaves, treedef = tree.flatten(X)
        return tree.unflatten(treedef, self.tp.cut(leaves, self.leaf_specs,
                                                   lead))

    def from_rank_rows(self, X, lead: int = 1):
        """Inverse of :meth:`to_rank_rows` (one process holding every
        model rank: ``StackedTP``)."""
        if self.tp.M == 1:
            return X
        leaves, treedef = tree.flatten(X)
        return tree.unflatten(treedef, self.tp.join(leaves, self.leaf_specs,
                                                    lead))

    def join_state(self, state: TrainState):
        """(X, D, H, Hw) of ``state`` as whole node-stacked trees (the Hw
        slots' lead is 2 under a time-varying plan)."""
        p = state.plead
        hw_lead = 1 if self.hw_slots is None else 2
        return {"X": self.from_rank_rows(p.X), "D": self.from_rank_rows(p.D),
                "H": self.from_rank_rows(p.comm.H),
                "Hw": self.from_rank_rows(p.comm.Hw, hw_lead)}

    def abstract_state(self) -> TrainState:
        """The state :meth:`init_state` makes, as ``meta`` tensors (the
        reference's ``abstract_state``): this process's rows (n_local,
        ...) of every leaf in the model's dtype (its rank-rows under a
        ``tp`` seam), D, H and Hw each their own storage, Hw with its T
        slots; nothing allocated."""
        X = tree.tree_map(
            lambda p: torch.empty((self.n_local,) + tuple(p.shape),
                                  dtype=p.dtype, device="meta"),
            TR.abstract_params(self.mcfg))
        return self._state_of(self.to_rank_rows(X))

    def _state_of(self, X) -> TrainState:
        zeros = lambda: tree.tree_map(torch.zeros_like, X)   # noqa: E731
        T = self.hw_slots
        hw0 = zeros() if T is None else tree.tree_map(
            lambda p: p.new_zeros((p.shape[0], T) + tuple(p.shape[1:])), X)
        plead = ProxLEADState(X, zeros(), CommState(zeros(), hw0),
                              OracleState(0, None, None), 1)
        precond = ((zeros(), zeros()) if self.tcfg.precondition == "adam"
                   else None)
        return TrainState(plead, 0, precond)

    # ------------------------------------------------------------------ loss
    def loss_and_grad(self, X, batch):
        """(mean node cross entropy, gradient of the SUM of node losses).
        ``batch``: this process's node rows; under a ``tp`` seam ``X`` is
        rank-rows, each rank-row reads its node's rows and backpropagates
        its copy of its node's loss, and the mean counts a node once."""
        tp = self.tp
        batch = tp.node_rows(batch)
        leaves_X, treedef = tree.flatten(X)
        xs = [x.detach().requires_grad_(True) for x in leaves_X]
        with torch.enable_grad():
            logits, _, aux = TR.forward(self.mcfg,
                                        tree.unflatten(treedef, xs), batch,
                                        tp=tp)
            ces = TR.loss_fn(self.mcfg, logits, batch["labels"], tp=tp)
            del logits
            total = (ces + self.tcfg.aux_weight * aux).sum()
            grads = torch.autograd.grad(total, xs, allow_unused=True)
        # a leaf the loss never reads (rwkv6's final_norm_b: its final norm
        # is an RMSNorm) has gradient zero, as under jax.grad
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, xs)]
        return (tp.first_of_node(ces.detach()).mean(),
                tree.unflatten(treedef, grads))

    def node_losses(self, X, batch) -> torch.Tensor:
        """Each node's loss of parameters ``X`` (the state's rows) on
        ``batch`` (this process's node rows), forward only -> (n_local,)."""
        tp = self.tp
        batch = tp.node_rows(batch)
        with torch.no_grad():
            logits = TR.forward(self.mcfg, X, batch, tp=tp)[0]
            return tp.first_of_node(TR.loss_fn(self.mcfg, logits,
                                               batch["labels"], tp=tp))

    # ------------------------------------------------------------------ step
    def train_step(self, state: TrainState, batch, draws: Draws
                   ) -> Tuple[TrainState, dict]:
        """One step; ``draws`` supplies the stochastic-rounding noise (one
        ``uniform`` per leaf, in leaf order; :mod:`repro_torch.optim.wire`
        for the model-sharded draw rule).  Consumes ``state`` on the
        neighbor backend (D, H and Hw are updated in place).  ``batch``
        holds every node's rows or this process's."""
        ce, G = self.loss_and_grad(state.plead.X, self.local_batch(batch))
        precond = state.precond
        if self.tcfg.precondition == "adam":
            G, precond = self._adam_precondition(G, precond, state.step)
        if self.sharded:
            G = tree.leaves(G)
            plead = self._sharded_update(state.plead, G, draws)
        else:
            plead = self.alg.update(state.plead, G, draws)
        del G
        if self.process_mesh is None and self.tp.M == 1:
            consensus = sum(((leaf - leaf.mean(0, keepdim=True)) ** 2).sum()
                            for leaf in tree.leaves(plead.X))
        elif self.process_mesh is None:     # StackedTP: (n, M) rank-rows
            consensus = sum(self._stacked_deviation(leaf, sp) for leaf, sp
                            in zip(tree.leaves(plead.X), self.leaf_specs))
        else:
            ce, consensus = self._reduced_metrics(ce, tree.leaves(plead.X))
        metrics = {"loss": ce, "consensus": consensus, "step": state.step}
        return TrainState(plead, state.step + 1, precond), metrics

    def local_batch(self, batch):
        """This process's rows of a batch of every node's rows (a batch of
        its own rows passes through)."""
        if self.n_local == self.tcfg.n_nodes:
            return batch
        lo, hi = self.node_lo, self.node_lo + self.n_local
        return {k: v[lo:hi] if v.shape[0] == self.tcfg.n_nodes else v
                for k, v in batch.items()}

    def _stacked_deviation(self, leaf, spec):
        """Sum over a leaf's rank-rows (n M, ...) of the squared deviation
        from the node mean, a replicated leaf counted once."""
        v = leaf.unflatten(0, (leaf.shape[0] // self.tp.M, self.tp.M))
        if sharding.model_dim(spec) is None:
            v = v[:, :1]
        return ((v - v.mean(0, keepdim=True)) ** 2).sum()

    def _reduced_metrics(self, ce, leaves):
        """The mean node loss and the consensus error over every rank's
        nodes: one all-reduce of the node sums (for the node mean), one of
        the loss and consensus partial sums (:attr:`all_reduce`).  On a
        :class:`repro_torch.launch.mesh.TPProcessMesh` the node sums go
        over the rank's node group (the ranks of its model shard), the
        partial sums over the world, model rank 0 alone counting the loss
        and the replicated leaves."""
        pm, N = self.process_mesh, self.tcfg.n_nodes
        node_group = getattr(pm, "node_group", pm.group)
        m = getattr(pm, "m", 0)
        sums = torch.cat([leaf.sum(0).reshape(-1) for leaf in leaves])
        self.all_reduce(sums, node_group)
        parts, off = [], 0
        for leaf, sp in zip(leaves, self.leaf_specs):
            n = leaf[0].numel()
            mean = (sums[off:off + n] / N).view(leaf.shape[1:])
            if m == 0 or sharding.model_dim(sp) is not None:
                parts.append(((leaf - mean) ** 2).sum())
            off += n
        del sums
        total = sum(parts) if parts else leaves[0].new_zeros(())
        tot = torch.stack([(ce * (self.n_local if m == 0 else 0))
                           .to(total.dtype), total])
        self.all_reduce(tot, pm.group)
        return tot[0] / N, tot[1]

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
    @property
    def _partial_manual(self) -> bool:
        """Does the reference's gossip ``shard_map`` leave the model axis
        to GSPMD?  On the JAX it is held to (>= 0.6, ``shard_map`` with
        partial-manual ppermute), the per-leaf wire does (identity
        compression always takes it); the bucketed wire reshapes across
        trailing dims, which must not gather the model axis, so it runs
        full-manual: each model shard quantizes its local slice."""
        use_bucket = (self.tcfg.wire_mode == "bucketed"
                      and not isinstance(self.compressor, Identity))
        return not use_bucket

    @property
    def wire_shards(self) -> int:
        """Model shards the wire cuts a node's leaves into: M under the
        full-manual bucketed wire, else 1."""
        return 1 if self._partial_manual else self.model_shards

    @property
    def model_sharded_leaf(self) -> Tuple[bool, ...]:
        """Per leaf, in leaf order: does the model axis shard it?  Empty
        under partial-manual, where no leaf is cut (the reference's
        ``model_sharded_leaf``)."""
        if self._partial_manual:
            return ()
        return tuple(sharding.spec_mentions(sp, "model")
                     for sp in self.leaf_specs)

    def wire_layout(self) -> bucket.BucketLayout:
        """The bucketed wire layout of one model shard of a node (one node
        at M = 1), from the parameter shapes alone (built once)."""
        if self._layout is None:
            from repro_torch.netsim.metrics import _model_local_shapes
            params = tree.leaves(TR.abstract_params(self.mcfg))
            _, local = _model_local_shapes(self, [p[None] for p in params])
            self._layout = bucket.compute_layout(
                [(1,) + tuple(s) for s in local],
                [p.dtype for p in params], bits=self.tcfg.bits,
                block_for=self._quant_block,
                scale_bytes=2 if self.tcfg.scales_bf16 else 4)
        return self._layout

    def _quant_block(self, diff_shape) -> int:
        """Quantization block size for a leaf as the quantizer sees it
        (the whole per-node leaf under partial-manual, its model-local
        slice under full-manual): the configured block, never wider than
        an even last dim; with ``shard_aligned_blocks`` the largest even
        divisor of the shard's last dim up to the block (2 if none), the
        shard being the last dim / ``tp_ways`` under partial-manual when
        that divides, else the slice itself, already local."""
        tcfg = self.tcfg
        blk = bucket.default_quant_block(diff_shape, tcfg.block)
        if tcfg.shard_aligned_blocks:
            ld = diff_shape[-1]
            if self._partial_manual and ld % tcfg.tp_ways == 0:
                shard = ld // tcfg.tp_ways
            else:
                shard = ld
            evens = [d for d in range(2, min(tcfg.block, shard) + 1, 2)
                     if shard % d == 0]
            blk = max(evens) if evens else 2
        return blk

    def _sharded_update(self, plead: ProxLEADState, G, draws: Draws
                        ) -> ProxLEADState:
        """Lines 6-10 with the COMM exchange moving packed payloads once
        per hop of the compiled ExchangePlan (a node-stacked port of the
        reference's ``local_step``).  ``G`` is the list of gradient leaves
        in X's leaf order; each is freed once used.  Under a time-varying
        plan the exchange mixes every round t' of the cycle, each Hw slot
        takes its round's W_t' Q, and round k % T is read.  The update runs
        on each leaf's model shards (:func:`sharding.shard_view`, views of
        the state), a replicated leaf on its shard 0."""
        tcfg = self.tcfg
        T = self.plan.T
        t = plead.k % T
        eta, alpha, gamma = tcfg.eta, tcfg.alpha, tcfg.gamma
        use_q = not isinstance(self.compressor, Identity)
        hop_pairs = [list(h.pairs) for h in self.plan.hops]
        leaves_X, treedef = tree.flatten(plead.X)
        D, H, Hw = (tree.leaves(t) for t in (plead.D, plead.comm.H,
                                             plead.comm.Hw))
        n, M, specs = leaves_X[0].shape[0], self.wire_shards, self.leaf_specs
        if self.tp.M > 1:
            # rank-rows are the wire's rows: each its own model-local leaf
            n, M = n, 1
            view = lambda a, sp, lead=1: a.unsqueeze(1)    # noqa: E731
        else:
            view = functools.partial(sharding.shard_view, model=M)
        wx = WireExchange(bits=tcfg.bits, block=tcfg.block,
                          scales_bf16=tcfg.scales_bf16,
                          pack_mode=tcfg.pack_mode,
                          block_for=self._quant_block)
        rows = None
        if use_q and tcfg.wire_mode == "bucketed":
            rows = bucket.RowTables(self.wire_layout(), n * M, self.device)
        zs, diffs = [], []
        for j, (x, d, h) in enumerate(zip(leaves_X, D, H)):
            z = x - eta * G[j] - eta * d
            G[j] = None
            if rows is None:
                diffs.append(z - h)
            else:                     # the diff lands in its group's rows
                rows.leaf_view(j).unflatten(0, (n, M)).copy_(
                    view(z - h, specs[j]))
            zs.append(z)
        # COMM: per leaf, the dequantized self payload and W Q
        if not use_q:
            wq, qs = wx.identity(diffs, self._wmat, hop_pairs, self.pp)
        elif rows is not None:
            wq, qs = wx.bucketed(rows, draws, self._wmat, hop_pairs, self.pp,
                                 sharded=self.model_sharded_leaf)
        else:
            wq, qs = wx.per_leaf(diffs, draws, self._wmat, hop_pairs,
                                 self.pp)
        del rows, diffs
        nX = []
        for j, (z, d, h, hw) in enumerate(zip(zs, D, H, Hw)):
            sp = specs[j]
            # (n, Mj, ...): the M shards, or one for a replicated leaf
            zv, dv, hv = (view(a, sp) for a in (z, d, h))
            mj = hv.shape[1]
            q = qs[j].unflatten(0, (n, M))[:, :mj]
            w = wq[j].unflatten(0, (n, M))[:, :mj]        # (n, Mj, T, ...)
            zhat = q.add_(hv)                             # h + Q_self
            if T == 1:
                hwv = view(hw, sp)
                zhat_w = w[:, :, 0].add_(hwv)             # Hw + (W Q)
                hwv.mul_(1 - alpha).add_(alpha * zhat_w)
            else:
                hwv = view(hw, sp, lead=2)
                zhat_w = hwv[:, :, t] + w[:, :, t]        # slot k % T
                # Hw[t'] tracks W_t' H: H += alpha Q => += alpha W_t' Q
                hwv.add_(w, alpha=alpha)
            hv.mul_(1 - alpha).add_(alpha * zhat)
            e = zhat.sub_(zhat_w)                         # zhat - zhat_w
            dv.add_(gamma / (2 * eta) * e)
            zv.sub_(gamma / 2.0 * e)
            nX.append(self.prox(z, eta))
            zs[j] = qs[j] = wq[j] = None
            del zv, dv, hv, hwv, q, w, zhat, zhat_w, e
        unf = lambda ls: tree.unflatten(treedef, ls)    # noqa: E731
        return ProxLEADState(unf(nX), plead.D,
                             CommState(plead.comm.H, plead.comm.Hw),
                             plead.oracle, plead.k + 1)
