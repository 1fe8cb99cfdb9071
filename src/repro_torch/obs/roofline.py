"""Roofline terms of a whole step on one NVIDIA H100, and the card's rates.

The port of ``repro.obs.roofline``.  Three terms per (arch, shape, cards),
all in seconds (per card):

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM traffic / HBM_BW
    collective = bytes a node sends / LINK_BW

The compute and memory terms come from the ANALYTIC model, verbatim in
arithmetic and operation order: the standard 6ND / 2ND accounting on the
active parameters, plus the attention quadratic, MoE dispatch and the
recurrences' elementwise state terms (:func:`analytic_flops`,
:func:`analytic_hbm_bytes`, :func:`model_flops`).

The reference fills two more columns from the compiled module: the
collective bytes parsed from its HLO text (loop-aware) and XLA's raw
``cost_analysis()`` FLOPs and bytes.  The port has no compiled module, so
:func:`analyze` runs one train step and records instead:

* ``hlo_flops`` -- the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
  counts over the step: every executed product (forward and backward).
  XLA's count sees a loop body once; this one sees every execution.  The
  kernels B1-B4 are launched through the binding, not through ATen, and
  count 0 (they do no products).
* ``hlo_bytes`` -- the bytes every executed ATen op reads and writes (its
  tensor operands and outputs, each once; views move nothing), as XLA's
  "bytes accessed" sums them per op.  Eager PyTorch fuses nothing, so this
  is close to the step's real HBM traffic; B1-B4 count 0 here too.
* ``coll_bytes`` -- the bytes one node sends through the ``pp(x, pairs)``
  seam (:class:`repro_torch.obs.record.RecordingPP`), under the key
  ``"collective-permute"``: what ``jax.lax.ppermute`` moves in the
  reference; on a process mesh also the bytes of the trainer's metric
  all-reduces (``"all-reduce"``).
* ``tp_bytes`` -- on a tensor-parallel node (``repro_torch.models.tp``),
  the bytes one rank-row hands the model axis's collectives over the step,
  forward and backward (:class:`repro_torch.obs.record.RecordingTP`), by
  kind: each collective's operand (a sum over ``DistTP`` moves 2 (M - 1)
  / M of it, as a ring all-reduce does).  On their own key: ``t_collective`` prices the node's wire and
  stays the reference's formula.

:func:`count_step` does this counting around one step; :func:`analyze`
calls it on a real step after a warm-up, and the dry run
(``repro_torch.launch.dryrun``) on a step of ``meta`` tensors, so the two
count the same way.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's H100 data sheet).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Tuple

#: H100 SXM f32 FLOP/s outside the tensor cores (67 TFLOP/s, NVIDIA's H100
#: data sheet): how the trainers' products run, since
#: ``torch.backends.cuda.matmul.allow_tf32`` is off.  If TF32 or bf16
#: products are ever allowed, this constant changes with them.
PEAK_FLOPS = 67e12
#: H100 SXM HBM3 bytes/s (3.35 TB/s, NVIDIA's H100 data sheet)
HBM_BW = 3.35e12
#: one direction of an H100 SXM's NVLink (900 GB/s both ways, NVIDIA's
#: H100 data sheet), bytes/s: the link the analytic wire time assumes
LINK_BW = 450e9


# ---------------------------------------------------------------------------
# Analytic FLOPs / HBM models (documented napkin math, per WHOLE JOB)
# ---------------------------------------------------------------------------

def analytic_flops(cfg, shape) -> float:
    """Forward FLOPs x (3 if training else 1), whole job (all cards).

    matmul params: 2 flops/param/token on ACTIVE params; attention adds
    4*B*T*T_kv*H*hd per layer (windowed T_kv = min(T, W)); MoE dispatch adds
    2*B*T*(E_cap)*D; recurrences add their elementwise state terms."""
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens = B          # one token per sequence
        T_q = 1
        T_kv = min(T, cfg.sliding_window or T) if cfg.family in ("dense", "moe", "vlm", "encdec") else T
    else:
        tokens = B * T
        T_q = T
        T_kv = min(T, cfg.sliding_window) if cfg.sliding_window else T

    n_active = cfg.param_count(active_only=True)
    f = 2.0 * n_active * tokens

    H, hd = cfg.n_heads, cfg.hd
    if cfg.family in ("dense", "moe", "vlm"):
        f += 4.0 * B * T_q * T_kv * H * hd * cfg.n_layers
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            f += 4.0 * B * T_q * cfg.n_vision_tokens * H * hd * n_cross
    if cfg.family == "encdec" and shape.kind != "decode":
        enc = T // 2 if shape.kind == "train" else min(T, 2 * cfg.max_source_positions)
        dec = T - enc
        f += 4.0 * B * enc * enc * H * hd * cfg.n_enc_layers
        f += 4.0 * B * dec * dec * H * hd * cfg.n_layers
        f += 4.0 * B * dec * enc * H * hd * cfg.n_layers
    if cfg.family == "encdec" and shape.kind == "decode":
        f += 4.0 * B * 1 * (T_kv + cfg.max_source_positions) * H * hd * cfg.n_layers
    if cfg.family == "moe":
        cap = cfg.top_k * cfg.capacity_factor
        f += 2.0 * B * max(T_q, 1) * cap * cfg.d_model * cfg.n_layers
    if cfg.family == "ssm":
        f += 4.0 * tokens * cfg.d_model * cfg.rwkv_head_size * cfg.n_layers
    if cfg.family == "hybrid":
        W = cfg.lru_width or cfg.d_model
        n_attn = cfg.n_layers // len(cfg.block_pattern)
        n_rec = cfg.n_layers - n_attn
        f += 8.0 * tokens * W * n_rec
        f += 4.0 * B * T_q * min(T_kv, cfg.local_window) * H * hd * n_attn

    if shape.kind == "train":
        f *= 3.0   # fwd + bwd(2x)
    return f


def analytic_hbm_bytes(cfg, shape, n_nodes: int, n_chips: int,
                       state_copies: float) -> float:
    """Per-card HBM traffic per step (napkin model, 2 B a parameter: the
    reference's bf16 model, kept as it is).  The port's trainers hold
    their parameters and state in f32, so on them this term is a lower
    bound (half the parameter bytes).

    train: every Prox-LEAD state (X,H,Hw,D) is read+written once, grads
    written+read once, weights read for fwd+bwd -> (2*state_copies + 4) *
    params_bytes_per_chip, + activation traffic ~ 12*B_loc*T*D*L bytes.
    serve: weights read once + full KV/state cache read (+1 token write).
    """
    pbytes = cfg.param_count() * 2.0
    B, T = shape.global_batch, shape.seq_len
    D, Lc = cfg.d_model, cfg.n_layers
    if shape.kind == "train":
        per_chip_params = pbytes * n_nodes / n_chips
        acts = 12.0 * (B / n_nodes) * T * D * Lc * 2.0 / (n_chips / n_nodes)
        return (2 * state_copies + 4) * per_chip_params + acts
    if shape.kind == "prefill":
        acts = 10.0 * B * T * D * Lc * 2.0 / n_chips
        return pbytes / n_chips + acts
    # decode: weights + cache
    if cfg.family == "ssm":
        hdv = cfg.rwkv_head_size
        cache = Lc * B * (D // hdv) * hdv * hdv * 2.0 + 2 * Lc * B * D * 2.0
    elif cfg.family == "hybrid":
        W = cfg.lru_width or D
        n_attn = Lc // len(cfg.block_pattern)
        cache = ((Lc - n_attn) * B * W * 4 * 2.0
                 + n_attn * B * min(T, cfg.local_window) * cfg.n_kv_heads
                 * cfg.hd * 2 * 2.0)
    else:
        S_eff = min(T, cfg.sliding_window) if cfg.sliding_window else T
        if getattr(cfg, "decode_cache_cap", None):
            S_eff = min(S_eff, cfg.decode_cache_cap)
        cache = Lc * B * S_eff * cfg.n_kv_heads * cfg.hd * 2 * 2.0
        if cfg.family == "encdec":
            cache += Lc * B * min(T, cfg.max_source_positions) \
                * cfg.n_kv_heads * cfg.hd * 2 * 2.0
        if cfg.family == "vlm":
            n_cross = Lc // cfg.cross_attn_every
            cache += n_cross * B * cfg.n_vision_tokens * cfg.n_kv_heads \
                * cfg.hd * 2 * 2.0
    return (pbytes + cache) / n_chips


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float          # analytic
    hbm_bytes_per_chip: float      # analytic
    coll_bytes: float              # bytes a node sends through the pp seam
    coll_breakdown: Dict[str, float]
    model_flops_per_chip: float    # 6ND / 2ND only (no attention terms)
    hlo_flops: float               # FlopCounterMode over one step
    hlo_bytes: float               # bytes the step's ATen ops read + write
    # a rank-row's model-axis bytes, by kind: not in :meth:`as_dict`,
    # whose keys are the reference's
    tp_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def tp_bytes(self):
        return sum(self.tp_breakdown.values())

    @property
    def t_compute(self):
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_ratio(self):
        return (self.model_flops_per_chip / self.flops_per_chip
                if self.flops_per_chip else 0.0)

    def as_dict(self):
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_ratio": self.useful_ratio,
            "hlo_flops_raw": self.hlo_flops, "hlo_bytes_raw": self.hlo_bytes,
        }


def model_flops(cfg, shape, n_params_active: int) -> float:
    """MODEL_FLOPS: 6ND train / 2ND inference-forward (N = active params)."""
    if shape.kind == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    return 2.0 * n_params_active * shape.global_batch


def train_shape(spec):
    """The InputShape of one train step of a sharded spec: every node's
    local batch (``n_nodes x local_batch`` sequences of ``seq_len``), as
    the reference's dry run and contract audit shape it."""
    from repro_torch.configs.shapes import InputShape
    ms = spec.model
    return InputShape("train_step", ms.seq_len,
                      spec.n_nodes * ms.local_batch, "train")


@dataclasses.dataclass
class StepCounts:
    """What :func:`count_step` counts over one step."""
    flops: float                  # FlopCounterMode's
    aten_bytes: float             # the ATen ops' operand + output bytes
    coll: Dict[str, float]        # bytes sent, by collective
    tp: Dict[str, float] = dataclasses.field(default_factory=dict)


def count_step(trainer, step: Callable[[], Any], tp=None
               ) -> Tuple[StepCounts, Any]:
    """Run ``step()`` -- one train step of ``trainer`` -- once under
    ``FlopCounterMode``, :class:`repro_torch.obs.record.StepRecorder`
    (``count_bytes``) and recorders in the trainer's ``pp``,
    ``all_reduce`` and ``tp`` seams (the all-reduces count on a process
    mesh, the tp seam at M > 1; ``trainer`` None: a step with no trainer
    seams, e.g. serving, whose ``tp`` seam may be given).  -> (its counts,
    what ``step`` returned)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.obs.record import (StepRecorder, recording_all_reduce,
                                        recording_pp, recording_tp)
    with contextlib.ExitStack() as seams:
        if trainer is not None:
            rec = seams.enter_context(recording_pp(trainer))
            ar = seams.enter_context(recording_all_reduce(trainer))
            tp = trainer.tp
        tp = None if tp is None else seams.enter_context(recording_tp(tp))
        counter = FlopCounterMode(display=False)
        with counter, StepRecorder(count_bytes=True) as sr:
            out = step()
    coll = {}
    if trainer is not None:
        coll["collective-permute"] = float(sum(b for _, b in rec.calls))
        if trainer.process_mesh is not None:
            coll["all-reduce"] = float(sum(b for _, b in ar.calls))
    return StepCounts(float(counter.get_total_flops()), float(sr.bytes),
                      coll, tp.bytes_by_kind() if tp is not None else {}
                      ), out


def roofline_of(cfg, shape, n_nodes: int, n_chips: int,
                counts: StepCounts, state_copies: float = 4.0) -> Roofline:
    """The analytic terms of ``cfg`` at ``shape`` beside a step's
    ``counts``."""
    n_active = cfg.param_count(active_only=True)
    return Roofline(
        flops_per_chip=analytic_flops(cfg, shape) / n_chips,
        hbm_bytes_per_chip=analytic_hbm_bytes(cfg, shape, n_nodes, n_chips,
                                              state_copies),
        coll_bytes=sum(counts.coll.values()),
        coll_breakdown=dict(counts.coll),
        model_flops_per_chip=model_flops(cfg, shape, n_active) / n_chips,
        hlo_flops=counts.flops,
        hlo_bytes=counts.aten_bytes,
        tp_breakdown=dict(counts.tp),
    )


def analyze(runner, cfg, shape, n_nodes: int, n_chips: int = 1,
            state_copies: float = 4.0, *, state=None, data=None,
            draws=None) -> Roofline:
    """The roofline of one train step of a :class:`repro_torch.api.
    TrainerRunner`: the analytic terms of ``cfg`` at ``shape``, and the
    counted FLOPs, ATen bytes and ``pp`` bytes of a step it runs (see the
    module docstring).  Two steps run from ``state`` (default: a fresh
    one; a given state is consumed, as ``TrainerRunner.step`` consumes
    it) over ``data`` (default: the spec's stream) and ``draws`` (default:
    a generator seeded ``spec.seed``): the first is the warm-up (caches,
    lazy index tensors), the second is counted (:func:`count_step`)."""
    from repro_torch.obs.record import warm_trainer

    state, batch, draws = warm_trainer(runner, state, data, draws)
    held = [state]
    del state
    counts, _ = count_step(
        runner.trainer, lambda: runner.step(held.pop(), batch, draws))
    return roofline_of(cfg, shape, n_nodes, n_chips, counts, state_copies)
