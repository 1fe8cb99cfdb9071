"""The dry run (``repro_torch.launch.dryrun``): a step on the ``meta``
device, against a real CPU step and against the reference's dry run.

* The kernels' ``meta`` route: each wrapper's outputs have the shapes and
  dtypes of the plain version's at (R, block) and of the binding's on the
  card (B1's leaf form: codes in the noise's shape, scales with its last
  axis 1; B5's z and B6's X in the leaf's shape); the inputs the binding
  refuses raise the binding's error types; ``LAUNCHES`` does not move and
  ``META_CALLS`` counts each call.
* ``MetaDraws`` makes the ATen ops ``GeneratorDraws`` makes.
* ``LiveBytes`` on CPU tensors: peak, argument, output and alias bytes of
  a block whose storages are known.
* Dry against real, on the CPU, at the reference's ``.reduced()`` qwen3:
  the neighbor backend on the ring and under ``alternating`` at (8, 1)
  and (4, 2), one node a rank and all in one process: the dry run's
  ``pp`` bytes equal a real CPU step's, call for call, and its ``gossip``
  block equals the runner's exact accounting; the dense backend with the
  identity compressor (no kernel on either side), in one process and on
  rank 0 of 8 (``"ranks"``, the default placement; the real rank's
  all-gather filled on the host): FLOPs, ATen bytes, the all-gather's and
  every other collective's bytes, and every memory figure equal the real
  step's, as integers; placement ``"tp"`` runs the dense backend and the
  per-leaf wire at one model shard.
* Against the reference, in one subprocess on 512 placeholder CPU devices
  (the reference's dry-run module sets them; built, never lowered): for
  every arch at ``train_4k`` on (16, 16) and on (2, 16, 16), the
  reference's per-device state bytes (``NamedSharding.shard_shape`` over
  ``state_specs``, the tensor leaves: the port holds the step counters
  as host integers) equal ``state_bytes_per_model_shard``, its gossip
  block equals the port's, and the parameter counts are equal.
* The skips over all 40 (arch, shape) pairs are the reference's.
* The CLI writes the reference's keys and exits 0.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs import shapes as tshapes
from repro_torch.core.draws import GeneratorDraws, MetaDraws, draws_on
from repro_torch.core.prox import L1
from repro_torch.kernels import ops as kops
from repro_torch.kernels import proxlead as kupd
from repro_torch.kernels import quantize as qk
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.obs.record import (LiveBytes, RecordingAllReduce,
                                    RecordingPP)
from repro_torch.optim.wire import DistAG, DryDistPP

ROOT = pathlib.Path(__file__).resolve().parent.parent
META = torch.device("meta")
#: the keys of the reference's record of a combo that ran
REF_KEYS = {"arch", "shape", "mesh", "backend", "variant", "bits",
            "topology", "pack_mode", "status", "chips", "params",
            "params_active", "memory", "roofline"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes",
              "alias_bytes"}
REF_ROOFLINE = {"flops_per_chip", "hbm_bytes_per_chip", "coll_bytes",
                "coll_breakdown", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "model_flops_per_chip",
                "useful_ratio", "hlo_flops_raw", "hlo_bytes_raw"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the real CPU steps: under a parallel pytest
    run the default pool spins for threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _m(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


# --- the kernels' meta route ---------------------------------------------------

def _plain_and_meta(kernel, dtype, bits, S=3, T=2, R=7, block=8):
    g = torch.Generator().manual_seed(0)
    if kernel == "qinf_quantize_blocks":
        x = torch.randn(R, block, generator=g).to(dtype)
        u = torch.rand(R, block, generator=g)
        return (lambda a, b: qk.qinf_quantize_blocks(a, b, bits)), (x, u)
    if kernel == "qinf_dequantize_blocks":
        c = torch.randint(-2, 3, (R, block), dtype=torch.int8, generator=g)
        s = torch.rand(R, 1, generator=g)
        return (lambda a, b: qk.qinf_dequantize_blocks(a, b, dtype)), (c, s)
    if kernel == "qinf_quantize_pack_blocks":
        x = torch.randn(R, block, generator=g)
        u = torch.rand(R, block, generator=g)
        return (lambda a, b: qk.qinf_quantize_pack_blocks(a, b, bits)), (x, u)
    if kernel == kupd.HEAD:           # ``bits``: the leaf's rank
        ops = [torch.randn((2,) + (3,) * (bits - 1) + (block,), generator=g)
               for _ in range(5)]
        return (lambda *a: kupd.head(*a[:4], 0.1, out=a[4])[0]), ops
    if kernel == kupd.TAIL:           # ``bits``: the Hw slots
        shape = (2, R, block)
        ops = [torch.randn(shape, generator=g) for _ in range(3)]
        ops[3:3] = [torch.randn((2, bits) + shape[1:], generator=g)]
        ops += [torch.randn(shape, generator=g),
                torch.randn((2, bits) + shape[1:], generator=g)]
        return (lambda *a: kupd.tail(*a, bits - 1, eta=0.1, alpha=0.5,
                                     gamma=1.0, prox=L1(0.1).elementwise(
                                         0.1))), ops
    W = qk.packed_width(block, bits)
    p = torch.randint(0, 255, (2, S, R, W), dtype=torch.uint8, generator=g)
    s = torch.rand(2, S, R, 1, generator=g)
    w = torch.rand(2, T, S, generator=g)
    return (lambda a, b, c: qk.qinf_unpack_dequant_mix_blocks(
        a, b, c, bits, dtype)), (p, s, w)


META_CASES = [(k, dt, b) for k in qk.LAUNCHES if k.startswith("qinf_")
              for dt in (torch.float32, torch.bfloat16, torch.float64)
              for b in (1, 2, 4, 7)
              if not (k == "qinf_quantize_pack_blocks" and dt != torch.float32)]
# B5 at leaves of rank 1-3, B6 at 1-3 Hw slots (f32 alone)
META_CASES += [(k, torch.float32, b) for k in (kupd.HEAD, kupd.TAIL)
               for b in (1, 2, 3)]


@pytest.mark.parametrize("kernel,dtype,bits", META_CASES, ids=str)
def test_meta_outputs_have_the_plain_shapes_and_dtypes(kernel, dtype, bits):
    fn, args = _plain_and_meta(kernel, dtype, bits)
    plain = fn(*args)
    qk.reset_launch_counts()
    qk.reset_meta_calls()
    dry = fn(*[a.to(META) for a in args])
    assert _sig(dry) == _sig(plain)
    assert all(t.is_meta for t in (dry if isinstance(dry, tuple) else (dry,)))
    assert qk.launch_counts() == dict.fromkeys(qk.LAUNCHES, 0)
    assert qk.meta_call_counts() == {k: int(k == kernel) for k in qk.LAUNCHES}


@pytest.mark.parametrize("shape,block", [((3, 7, 300), 256), ((129,), 128),
                                         ((5, 256), 256), ((), 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_b1_leaf_route_on_meta_is_the_cards(shape, block, dtype):
    """``ops.qinf_quantize_lastdim`` hands B1 the whole leaf on ``meta``,
    as on the card: codes in the blocked noise's shape, scales with its
    last axis 1 -- the plain path's outputs, which pad the leaf first."""
    x = torch.randn(shape).to(dtype)
    u = torch.rand(kops.blockwise_shape(x.shape, block))
    plain = kops.qinf_quantize_lastdim(x, u, bits=2, block=block)
    qk.reset_meta_calls()
    dry = kops.qinf_quantize_lastdim(x.to(META), u.to(META), bits=2,
                                     block=block)
    assert _sig(dry) == _sig(plain) == [
        (tuple(u.shape), torch.int8),
        (tuple(u.shape[:-1]) + (1,), torch.float32)]
    assert qk.meta_call_counts()["qinf_quantize_blocks"] == 1
    codes, scales = dry
    out = kops.qinf_dequantize_lastdim(codes, scales, x.shape, dtype,
                                       block=block)
    assert out.is_meta and out.shape == x.shape and out.dtype == dtype


def test_b1_per_point_levels_on_meta():
    x, u = _m((4, 6, 256)), _m((4, 6, 1, 256))
    codes, scales = qk.qinf_quantize_blocks(x, u, 2, levels=_m((4,)))
    assert _sig((codes, scales)) == [((4, 6, 1, 256), torch.int8),
                                     ((4, 6, 1, 1), torch.float32)]
    with pytest.raises(ValueError):
        qk.qinf_quantize_blocks(x, u, 2, levels=_m((5,)))
    with pytest.raises(TypeError):
        qk.qinf_quantize_blocks(x, u, 2, levels=_m((4,), torch.float64))


REFUSED = [
    ("B1 bits 9", lambda: qk.qinf_quantize_blocks(_m((4, 8)), _m((4, 8)), 9),
     ValueError),
    ("B1 bits 0", lambda: qk.qinf_quantize_blocks(_m((4, 8)), _m((4, 8)), 0),
     ValueError),
    ("B1 f64 noise", lambda: qk.qinf_quantize_blocks(
        _m((4, 8)), _m((4, 8), torch.float64), 2), TypeError),
    ("B1 int x", lambda: qk.qinf_quantize_blocks(
        _m((4, 8), torch.int32), _m((4, 8)), 2), TypeError),
    ("B1 noise shape", lambda: qk.qinf_quantize_blocks(
        _m((4, 8)), _m((4, 2, 8)), 2), ValueError),
    ("B1 noise not contiguous", lambda: qk.qinf_quantize_blocks(
        _m((4, 8)), _m((8, 4)).t(), 2), ValueError),
    ("B1 strided rows", lambda: qk.qinf_quantize_blocks(
        _m((4, 16))[:, ::2], _m((4, 8)), 2), ValueError),
    ("B2 int16 codes", lambda: qk.qinf_dequantize_blocks(
        _m((4, 8), torch.int16), _m((4, 1))), TypeError),
    ("B2 f16 out", lambda: qk.qinf_dequantize_blocks(
        _m((4, 8), torch.int8), _m((4, 1)), torch.float16), TypeError),
    ("B2 scales shape", lambda: qk.qinf_dequantize_blocks(
        _m((4, 8), torch.int8), _m((4, 2))), ValueError),
    ("B3 bits 8", lambda: qk.qinf_quantize_pack_blocks(
        _m((4, 8)), _m((4, 8)), 8), ValueError),
    ("B3 bf16 x", lambda: qk.qinf_quantize_pack_blocks(
        _m((4, 8), torch.bfloat16), _m((4, 8)), 2), TypeError),
    ("B3 odd nibble block", lambda: qk.qinf_quantize_pack_blocks(
        _m((4, 7)), _m((4, 7)), 2), ValueError),
    ("B3 shapes", lambda: qk.qinf_quantize_pack_blocks(
        _m((4, 8)), _m((4, 6)), 2), ValueError),
    ("B3 not contiguous", lambda: qk.qinf_quantize_pack_blocks(
        _m((8, 4)).t(), _m((4, 8)), 2), ValueError),
    ("B4 bits 8", lambda: qk.qinf_unpack_dequant_mix_blocks(
        _m((2, 3, 4, 8), torch.uint8), _m((2, 3, 4, 1)), _m((2, 1, 3)), 8),
     ValueError),
    ("B4 f64 scales", lambda: qk.qinf_unpack_dequant_mix_blocks(
        _m((2, 3, 4, 8), torch.uint8), _m((2, 3, 4, 1), torch.float64),
        _m((2, 1, 3)), 4), TypeError),
    ("B4 senders", lambda: qk.qinf_unpack_dequant_mix_blocks(
        _m((2, 3, 4, 8), torch.uint8), _m((2, 3, 4, 1)), _m((2, 1, 2)), 4),
     ValueError),
    ("B4 rank", lambda: qk.qinf_unpack_dequant_mix_blocks(
        _m((3, 4, 8), torch.uint8), _m((3, 4, 1)), _m((1, 1, 3)), 4),
     ValueError),
    ("B5 f64 leaf", lambda: kupd.head(
        _m((2, 8)), _m((2, 8), torch.float64), _m((2, 8)), _m((2, 8)), 0.1),
     TypeError),
    ("B5 shapes", lambda: kupd.head(
        _m((2, 8)), _m((2, 8)), _m((2, 9)), _m((2, 8)), 0.1), ValueError),
    ("B5 diff rows", lambda: kupd.head(
        _m((2, 8)), _m((2, 8)), _m((2, 8)), _m((2, 8)), 0.1,
        out=_m((2, 16))[:, ::2]), ValueError),
    ("B6 slots", lambda: kupd.tail(
        _m((2, 8)), _m((2, 8)), _m((2, 8)), _m((2, 2, 8)), _m((2, 8)),
        _m((2, 3, 8)), 0, eta=0.1, alpha=0.5, gamma=1.0,
        prox=L1(0.1).elementwise(0.1)), ValueError),
    ("B6 slot index", lambda: kupd.tail(
        _m((2, 8)), _m((2, 8)), _m((2, 8)), _m((2, 2, 8)), _m((2, 8)),
        _m((2, 2, 8)), 2, eta=0.1, alpha=0.5, gamma=1.0,
        prox=L1(0.1).elementwise(0.1)), ValueError),
]


@pytest.mark.parametrize("what,call,exc", REFUSED, ids=[r[0] for r in REFUSED])
def test_meta_route_refuses_what_the_binding_refuses(what, call, exc):
    qk.reset_meta_calls()
    with pytest.raises(exc):
        call()
    assert qk.meta_call_counts() == dict.fromkeys(qk.LAUNCHES, 0)


# --- MetaDraws and LiveBytes ---------------------------------------------------

class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func._schema.name, _sig(out) if isinstance(
            out, (torch.Tensor, tuple)) else None))
        return out


@pytest.mark.parametrize("call", ["uniform", "uniform_out", "uniform_f64",
                                  "randint", "bernoulli", "choice"])
def test_meta_draws_make_the_generator_draws_ops(call):
    def run(d, dev):
        with _Ops() as rec:
            if call == "uniform":
                t = d.uniform((3, 5))
            elif call == "uniform_out":
                t = d.uniform((3, 5), out=torch.empty(3, 5, device=dev))
            elif call == "uniform_f64":
                t = d.uniform((4,), dtype=torch.float64, low=-1.0)
            elif call == "randint":
                t = d.randint(6, 10)
            elif call == "bernoulli":
                t = d.bernoulli(0.3, (2, 3))
            else:
                t = d.choice(9, 4)
        return rec.ops, t
    real_ops, real = run(GeneratorDraws(0, "cpu"), "cpu")
    dry_ops, dry = run(draws_on(0, "meta"), META)
    assert dry.is_meta and _sig(dry) == _sig(real)
    assert [n for n, _ in dry_ops] == [n.replace("generator", "")
                                       for n, _ in real_ops]
    assert [s for _, s in dry_ops] == [s for _, s in real_ops]


def test_draws_on_picks_the_source_by_device():
    assert isinstance(draws_on(3, "meta"), MetaDraws)
    assert isinstance(draws_on(3, "cpu"), GeneratorDraws)


def test_live_bytes_follows_storages():
    a = torch.ones(100)                                  # 400 B argument
    with LiveBytes((a,)) as lb:
        b = a * 2                                        # +400
        c = b + 1                                        # +400: 1200
        del b                                            # -400
        d = c.view(10, 10)                               # a view: +0
        e = torch.cat([d, d])                            # +800: 1600
        del e
        a.mul_(3)                                        # in place: +0
    assert (lb.argument_bytes, lb.peak, lb.live) == (400, 1600, 800)
    assert lb.outputs((a, c, d)) == {"output_bytes": 800, "alias_bytes": 400}
    del c, d
    assert lb.live == 400


# --- dry against real on the CPU -----------------------------------------------

SMALL_SHAPE = tshapes.InputShape("train_small", 16, 16, "train")


def _small_cfg():
    return tconfigs.get("qwen3-1.7b").reduced()


def _spec(cfg, mesh, *, backend="neighbor", schedule="static",
          compressor="qinf"):
    spec = dryrun.train_spec(cfg, mesh, backend=backend)
    return dataclasses.replace(
        spec, topology=tapi.TopologySpec(graph="ring", schedule=schedule),
        compressor=tapi.CompressorSpec(
            compressor, {"bits": 2} if compressor == "qinf" else {}))


def _real_counts(spec, cfg, shape):
    """A real CPU step of ``spec``, counted as the dry run counts (one
    warm-up step, then the counters), from a fresh state, and its pp
    calls."""
    runner = tapi.build_trainer_runner(spec, device="cpu", model_cfg=cfg)
    tr = runner.trainer
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, s, generator=g)
             for k, (s, _) in tshapes.train_input_specs(
                 cfg, shape, spec.n_nodes).items()}
    rec = RecordingPP()
    tr.pp = rec
    counts, memory, calls, _ = dryrun.counted_step(
        tr, [tr.init_state()], batch, GeneratorDraws(0, "cpu"))
    return runner, counts, memory, calls, list(rec.calls)


def _dry(spec, cfg, mesh, placement):
    tr, _ = dryrun.meta_trainer(spec, mesh, cfg, placement)
    batch = {k: torch.empty((tr.n_local,) + tuple(s[1:]), dtype=dt,
                            device=META)
             for k, (s, dt) in tshapes.train_input_specs(
                 cfg, SMALL_SHAPE, spec.n_nodes).items()}
    counts, memory, calls, new = dryrun.counted_step(
        tr, [tr.abstract_state()], batch)
    assert all(t.is_meta for t in tree.leaves(new.plead.X))
    return tr, counts, memory, calls


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)], ids=str)
@pytest.mark.parametrize("schedule", ["static", "alternating"])
def test_dry_pp_bytes_and_gossip_equal_a_real_cpu_step(mesh_shape, schedule):
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh(mesh_shape)
    spec = _spec(cfg, mesh, schedule=schedule)
    runner, real, _, _, real_calls = _real_counts(spec, cfg, SMALL_SHAPE)
    hops = len(runner.trainer.plan.hops)
    assert len(real_calls) == 2 * hops
    for placement in dryrun.PLACEMENTS:
        tr, dry, _, calls = _dry(spec, cfg, mesh, placement)
        assert dry.coll["collective-permute"] == \
            real.coll["collective-permute"] > 0, placement
        # node-stacked products: a rank of one node does 1/N of them
        assert dry.flops * (spec.n_nodes // tr.n_local) == real.flops
        assert calls["qinf_quantize_pack_blocks"] == \
            calls["qinf_unpack_dequant_mix_blocks"] == \
            len(tr.wire_layout().groups)
        gossip = dryrun.gossip_block(tr)
        # a node rank: its pp calls are one row each, and the all-reduces
        # of the consensus metric run (one process: none)
        ranks = placement == "ranks"
        assert (dry.coll.get("all-reduce", 0) > 0) == ranks
        assert gossip["hops"] * gossip["payload_bits_per_edge"] == \
            runner.bits_per_step() == 8 * sum(b for _, b in real_calls)
        assert gossip["bits_per_round"] == \
            gossip["pairs_per_round"] * gossip["payload_bits_per_edge"]
        assert gossip["pairs_per_round"] == runner.trainer.plan.pairs_per_round
        assert gossip["plan"] == runner.trainer.plan.name


def test_dense_identity_dry_step_equals_the_real_cpu_step():
    """No kernel runs on either side, so every count is the real one."""
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh((8, 1))
    spec = _spec(cfg, mesh, backend="dense", compressor="identity")
    _, real, real_mem, real_calls, _ = _real_counts(spec, cfg, SMALL_SHAPE)
    _, dry, dry_mem, calls, = _dry(spec, cfg, mesh, "one process")
    assert (dry.flops, dry.aten_bytes) == (real.flops, real.aten_bytes)
    assert dry.flops > 0 and dry.aten_bytes > 0
    assert dry_mem == real_mem
    assert dry_mem["peak_bytes"] > dry_mem["argument_bytes"] > 0
    assert calls == real_calls == dict.fromkeys(qk.LAUNCHES, 0)


def test_dense_qinf_dry_step_calls_b1_b2_once_a_leaf():
    """In one process and on ranks (the default placement); a rank
    all-gathers every other node's Q of each leaf, in the leaf's dtype."""
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh((8, 1))
    spec = _spec(cfg, mesh, backend="dense")
    for placement in dryrun.PLACEMENTS:
        tr, dry, mem, calls = _dry(spec, cfg, mesh, placement)
        leaves = tree.leaves(tr.abstract_state().plead.X)
        assert calls["qinf_quantize_blocks"] == \
            calls["qinf_dequantize_blocks"] == len(leaves)
        if placement == "one process":
            assert dry.coll == {"collective-permute": 0.0}
            continue
        assert tr.n_local == 1
        assert dry.coll["all-gather"] == 7 * sum(
            x.numel() * x.element_size() for x in leaves) > 0
    assert dryrun.meta_trainer(spec, mesh, cfg)[1] == "ranks"


class _HostFilledAG(DistAG):
    """A rank's all-gather with no process group: its own rows, the
    others zero, written through numpy (no ATen op: the step's counts are
    a dry rank's)."""

    def _transfer(self, out, x):
        a = out.numpy()
        a[:] = 0
        a[self.pm.lo:self.pm.hi] = x.numpy()


def test_dense_ranks_dry_step_equals_the_real_cpu_step():
    """The dense backend on ranks, rank 0 of 8 (identity compression: no
    kernel on either side): a real CPU step of the rank (its all-gather
    filled on the host) and the dry one have equal FLOPs, ATen bytes,
    ``pp``, all-reduce and all-gather bytes, and memory figures."""
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh((8, 1))
    spec = _spec(cfg, mesh, backend="dense", compressor="identity")
    pm = mesh_mod.ProcessMesh(mesh, rank=0, world=8)
    runner = tapi.build_trainer_runner(
        spec, device="cpu", model_cfg=cfg, process_mesh=pm,
        pp=DryDistPP(pm), ag=_HostFilledAG(pm))
    tr = runner.trainer
    tr.all_reduce = RecordingAllReduce()
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (1,) + tuple(s[1:]), generator=g)
             for k, (s, _) in tshapes.train_input_specs(
                 cfg, SMALL_SHAPE, spec.n_nodes).items()}
    real, real_mem, real_calls, _ = dryrun.counted_step(
        tr, [tr.init_state()], batch, GeneratorDraws(0, "cpu"))
    _, dry, dry_mem, calls = _dry(spec, cfg, mesh, "ranks")
    assert (dry.flops, dry.aten_bytes) == (real.flops, real.aten_bytes)
    assert dry.coll == real.coll and real.coll["all-gather"] > 0
    assert dry_mem == real_mem
    assert calls == real_calls == dict.fromkeys(qk.LAUNCHES, 0)


@pytest.mark.parametrize("execution", [{"backend": "dense"},
                                       {"wire_mode": "per_leaf"}], ids=str)
def test_whole_leaf_jobs_dry_run_at_one_model_shard(execution):
    """Placement "tp" of the dense backend and the per-leaf wire: rank
    (0, 0) holds one model shard, gathers each sharded leaf's diff over
    the model ranks ("all-gather" TP bytes) and, on the dense backend,
    every node's Q of its shard over its node group."""
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh((8, 2))
    spec = dataclasses.replace(_spec(cfg, mesh), execution=dataclasses.replace(
        _spec(cfg, mesh).execution, **execution))
    rec = dryrun.dry_train(cfg, SMALL_SHAPE, mesh, placement="tp",
                           spec=spec)
    assert rec["placement"] == "tp" and rec["model_shards_per_card"] == 1
    assert rec["cards"] == 16
    assert rec["state_bytes_per_rank"] == rec["state_bytes_per_model_shard"]
    assert rec["tp_breakdown"]["all-gather"] > 0
    dense = execution.get("backend") == "dense"
    assert (rec["all_gather_bytes"] > 0) == dense
    assert (rec["roofline"]["coll_breakdown"]["collective-permute"] > 0) \
        == (not dense)


def test_dry_train_record_at_a_small_size():
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh((8, 2))
    rec = dryrun.dry_train(cfg, SMALL_SHAPE, mesh, backend="neighbor")
    assert rec["placement"] == "ranks" and rec["cards"] == 8
    assert rec["nodes_per_card"] == 1
    mem = rec["memory"]
    assert REF_MEMORY <= set(mem) and mem["code_bytes"] is None
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["alias_bytes"] > 0 and mem["fits"]
    assert REF_ROOFLINE <= set(rec["roofline"])
    k = rec["kernels"]
    assert k["qinf_quantize_pack_blocks"]["calls"] > 0
    assert k["qinf_unpack_dequant_mix_blocks"]["bound_bytes"] > 0


# --- against the reference -----------------------------------------------------

_REF_CODE = """
import json, math
from repro.launch import dryrun as D  # noqa: F401  (512 devices, first)
import dataclasses
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import api, configs
from repro.launch import mesh as mesh_mod
from repro.models.sharding import node_axes
from repro.netsim import metrics as nm
out = {}
for multi_pod in (False, True):
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    for arch in configs.ARCH_IDS:
        cfg = dataclasses.replace(configs.get(arch), dtype=jnp.bfloat16)
        spec = api.ExperimentSpec(
            name="dryrun-neighbor-ring", n_nodes=mesh_mod.n_nodes(mesh),
            algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(1e-2),
                                        alpha=api.constant(0.5),
                                        gamma=api.constant(1.0)),
            compressor=api.CompressorSpec("qinf", {"bits": 2}),
            topology=api.TopologySpec(graph="ring"),
            execution=api.ExecutionSpec(engine="sharded", backend="neighbor",
                                        pack_mode="lastdim", params={}))
        tr = api.build_trainer_runner(spec, model_cfg=cfg, mesh=mesh).trainer
        st = tr.abstract_state()
        ls = jax.tree_util.tree_leaves(st)
        ss = jax.tree_util.tree_leaves(tr.state_specs(node_axes(mesh)),
                                       is_leaf=lambda x: isinstance(x, P))
        assert len(ls) == len(ss)
        state = sum(math.prod(NamedSharding(mesh, s).shard_shape(l.shape))
                    * l.dtype.itemsize for l, s in zip(ls, ss) if l.ndim)
        per_edge = nm.sharded_payload_bits(
            tr, jax.tree_util.tree_leaves(st.plead.X))
        out[f"{arch} {multi_pod}"] = {
            "state": state, "params": cfg.param_count(),
            "active": cfg.param_count(active_only=True),
            "chips": mesh_mod.n_chips(mesh), "nodes": mesh_mod.n_nodes(mesh),
            "gossip": {"plan": tr.plan.name, "hops": len(tr.plan.hops),
                       "wire_mode": tr.tcfg.wire_mode,
                       "pairs_per_round": tr.plan.pairs_per_round,
                       "payload_bits_per_edge": per_edge,
                       "bits_per_round": nm.plan_bits_per_round(tr.plan,
                                                                per_edge)}}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_records():
    """The reference's trainers at ``train_4k`` on its production meshes,
    built (never lowered) in a subprocess: its dry-run module sets 512
    placeholder devices at import, which the pytest worker must not."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_CODE], capture_output=True,
                       text=True, env=env, timeout=300)
    line = [s for s in r.stdout.splitlines() if s.startswith("REF ")]
    assert line, r.stdout + r.stderr[-3000:]
    return json.loads(line[0][4:])


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_state_gossip_and_params_equal_the_reference(reference_records,
                                                     arch, multi_pod):
    want = reference_records[f"{arch} {multi_pod}"]
    cfg = dataclasses.replace(tconfigs.get(arch), dtype=torch.bfloat16)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    tr, placement = dryrun.meta_trainer(dryrun.train_spec(cfg, mesh), mesh,
                                        cfg)
    assert placement == "ranks" and tr.n_local == 1
    assert (mesh_mod.n_chips(mesh), mesh_mod.n_nodes(mesh)) == \
        (want["chips"], want["nodes"])
    assert dryrun.state_bytes_per_model_shard(tr) == want["state"]
    assert dryrun.gossip_block(tr) == want["gossip"]
    assert cfg.param_count() == want["params"]
    assert cfg.param_count(active_only=True) == want["active"]


def test_skips_equal_the_reference():
    from repro import configs as jconfigs
    from repro.configs import shapes as jshapes
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    pairs = [(a, s) for a in tconfigs.ARCH_IDS for s in tshapes.SHAPES]
    assert len(pairs) == 40
    port = {(a, s): tshapes.applicable(tconfigs.get(a), tshapes.SHAPES[s])
            for a, s in pairs}
    ref = {(a, s): jshapes.applicable(jconfigs.get(a), jshapes.SHAPES[s])
           for a, s in pairs}
    assert port == ref
    assert sum(v is not None for v in port.values()) == 7
    a, s = next(p for p, v in port.items() if v is not None)
    rec = dryrun.run_one(a, s, out_dir=None, verbose=False)
    assert rec["status"] == "skipped" and rec["reason"] == ref[(a, s)]


# --- the CLI -------------------------------------------------------------------

def test_cli_covers_every_arch_and_writes_the_reference_keys(tmp_path):
    """Every arch at ``decode_32k`` (the shape every arch runs whose dry
    step is quickest), and the neighbor backend's train record of one."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "all", "--shape", "decode_32k", "--out",
                     str(tmp_path)])
    assert e.value.code == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(tconfigs.ARCH_IDS)
    for f in files:
        rec = json.loads(f.read_text())
        assert rec["status"] == "ok" and REF_KEYS <= set(rec), f.name
        assert REF_MEMORY <= set(rec["memory"])
        assert REF_ROOFLINE <= set(rec["roofline"])
        assert rec["chips"] == 256 and rec["memory"]["code_bytes"] is None


def test_cli_exits_1_when_a_combo_errs(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("a fault")
    monkeypatch.setattr(dryrun, "dry_serve", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["status"] == "error" and "a fault" in rec["error"]


def test_mesh_functions_name_the_reference_counts():
    one, two = (mesh_mod.make_production_mesh(multi_pod=m)
                for m in (False, True))
    assert (mesh_mod.n_nodes(one), mesh_mod.n_chips(one)) == (16, 256)
    assert (mesh_mod.n_nodes(two), mesh_mod.n_chips(two)) == (32, 512)
    assert mesh_mod.n_nodes(one) == one.n_nodes


# --- a tensor-parallel node: placement "tp" ----------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_tp_rank_state_bytes_equal_a_model_shard(reference_records, arch):
    """Placement "tp" on (16, 16): rank (0, 0) of 256 holds one model shard
    of one node, whose Prox-LEAD state (X, D, H, Hw) is, to the byte,
    ``state_bytes_per_model_shard`` and the reference's per-device state."""
    from repro_torch.models import tp as tp_mod
    cfg = dataclasses.replace(tconfigs.get(arch), dtype=torch.bfloat16)
    mesh = mesh_mod.make_production_mesh()
    tr, placement = dryrun.meta_trainer(dryrun.train_spec(cfg, mesh), mesh,
                                        cfg, "tp")
    assert placement == "tp" and tr.n_local == 1
    assert isinstance(tr.tp, tp_mod.DryDistTP) and tr.tp.M == 16
    rank = dryrun.state_bytes_per_rank(tr)
    assert rank == dryrun.state_bytes_per_model_shard(tr) == \
        reference_records[f"{arch} False"]["state"]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_tp_placement_runs_every_family_and_shape(arch):
    """Placement "tp" runs every family: ``decode_32k`` on (16, 16) by
    ``run_one`` (a decode step of rank (0, 0) on its cache), each record
    carrying ``cache_bytes_per_rank`` beside the whole node's and its even
    split; no combo that ``applicable`` admits is skipped."""
    rec = dryrun.run_one(arch, "decode_32k", backend="neighbor",
                         out_dir=None, verbose=False, placement="tp")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["placement"] == "tp" and rec["model_shards_per_card"] == 1
    assert rec["cards"] == 256 and rec["tp_bytes"] > 0
    whole = rec["cache_bytes_whole_node"]
    assert rec["cache_bytes_even_split"] == whole // 16
    assert whole // 16 <= rec["cache_bytes_per_rank"] <= whole
    for shape in tshapes.SHAPES:
        cfg = tconfigs.get(arch)
        rec = dryrun.run_one(arch, shape, backend="neighbor", out_dir=None,
                             verbose=False, placement="tp") \
            if tshapes.applicable(cfg, tshapes.SHAPES[shape]) else None
        assert rec is None or (rec["status"] == "skipped" and
                               rec["reason"] == tshapes.applicable(
                                   cfg, tshapes.SHAPES[shape]))


@pytest.mark.parametrize("arch,layers", [("rwkv6-7b", 1),
                                         ("recurrentgemma-9b", 3)])
def test_tp_placement_trains_the_recurrent_families(arch, layers):
    """RWKV-6 and the RG-LRU train at rank (0, 0) of (16, 16): published
    widths, ``train_4k``'s batch, cut to ``layers`` layers and 64 tokens
    (their recurrences loop over the tokens: the whole ``train_4k`` combos
    take ~1 h and ~8 min on one core, ``python -m repro_torch.launch.
    dryrun --placement tp`` runs them).  The rank's state is one model
    shard's; the TP bytes carry ``scatter_last``'s gathers."""
    cfg = dataclasses.replace(tconfigs.get(arch), dtype=torch.bfloat16,
                              n_layers=layers)
    shape = dataclasses.replace(tshapes.SHAPES["train_4k"], seq_len=64)
    rec = dryrun.dry_train(cfg, shape, mesh_mod.make_production_mesh(),
                           placement="tp")
    assert rec["placement"] == "tp" and rec["cards"] == 256
    assert rec["state_bytes_per_rank"] == rec["state_bytes_per_model_shard"]
    assert rec["tp_breakdown"]["all-gather-grad"] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]


def test_cache_bytes_per_rank_are_the_heads_and_columns_a_rank_holds():
    """``cache_bytes_per_rank`` of a decode record equals the bytes of the
    cache entries rank (0, 0) holds, counted from the whole node's cache
    leaf by leaf: its KV heads (``kv_heads_per_rank`` of the whole KV),
    RWKV-6's wkv state of H / M heads, the RG-LRU's W / M columns, the
    token shifts whole."""
    from repro_torch.models import transformer as TR
    shape = tshapes.SHAPES["decode_32k"]
    mesh = mesh_mod.make_production_mesh()
    for arch in tconfigs.ARCH_IDS:
        cfg = dataclasses.replace(tconfigs.get(arch), dtype=torch.bfloat16)
        rec = dryrun.dry_serve(cfg, shape, mesh, placement="tp")
        Bl = rec["batch_rows_per_card"]
        kv = TR.kv_heads_per_rank(cfg, 16)
        want = 0
        for path, x in tree.flatten_with_paths(TR.init_cache(
                cfg, Bl, shape.seq_len, abstract=True)):
            name = path.rsplit("/", 1)[-1]
            n = x.numel() * x.element_size()
            if name in ("k", "v"):
                n = n // cfg.n_kv_heads * kv
            elif name in ("wkv", "h", "conv"):
                n //= 16
            want += n
        assert rec["cache_bytes_per_rank"] == want, arch
        assert rec["cache_bytes_whole_node"] == sum(
            x.numel() * x.element_size() for x in tree.leaves(
                TR.init_cache(cfg, Bl, shape.seq_len, abstract=True)))


def test_tp_bytes_of_a_head_aligned_step_have_a_closed_form():
    """A head-aligned dense config (16 heads of 32, 16 KV heads, qk_norm)
    dry-run at rank (0, 0) of the (16, 16) mesh: the bytes a rank hands the
    model axis in a train step, as integers.  Forward: the embedding's
    ``reduce_out`` and each layer's two (attention, MLP), B T D each;
    backward: the LM head's ``copy_in`` and each layer's two, B T D each,
    and each layer's ``q_norm`` and ``k_norm`` gradients, hd each; the
    loss: the max (``all-reduce-max``), the sum of exponentials and the
    label's logit, B T f32 each.  No gather on aligned heads."""
    cfg = dataclasses.replace(tconfigs.get("qwen3-1.7b").reduced(
        n_layers=2, d_model=256), n_heads=16, n_kv_heads=16)
    L_, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    assert cfg.qk_norm and (cfg.n_heads * hd) % 16 == 0 and hd == 32
    mesh = mesh_mod.make_production_mesh()
    Bl, T = 2, 16
    shape = tshapes.InputShape("train_small", T, 16 * Bl, "train")
    rec = dryrun.dry_train(cfg, shape, mesh, placement="tp")
    isz = 4                                   # f32
    act = Bl * T * D * isz
    want = {"all-reduce": (4 * L_ + 2) * act + 2 * L_ * hd * isz
            + 2 * Bl * T * 4,
            "all-reduce-max": Bl * T * 4}
    assert rec["tp_breakdown"] == want
    assert rec["tp_bytes"] == sum(want.values())
    assert rec["cards"] == 256 and rec["model_shards_per_card"] == 1
    assert rec["state_bytes_per_rank"] == rec["state_bytes_per_model_shard"]
    # the wire of one shard: the rank sends its shard's payload a hop
    gossip = rec["gossip"]
    assert rec["roofline"]["coll_breakdown"]["collective-permute"] * 8 * 16 \
        == gossip["hops"] * gossip["payload_bits_per_edge"]


def test_tp_bytes_of_an_rwkv6_step_have_a_closed_form():
    """RWKV-6 (16 heads of 32, d_ff 1024, f32) dry-run at rank (0, 0) of
    the (16, 16) mesh: the bytes a rank hands the model axis in a train
    step, as integers.  All-reduce: the embedding's ``reduce_out`` and the
    LM head's ``copy_in`` (B T D each); a layer's ``rwkv_wo``
    ``reduce_out``, the backward of the ddlerp's four ``copy_in``s and of
    the channel mix's two (B T D each), of its gathered squared ReLU (B T
    F); the loss's two sums (B T f32).  All-reduce-max: the loss's max.
    All-gather (forward): a layer's squared ReLU (B T F / M) and its
    output columns (B T D / M).  All-gather-grad (``scatter_last``'s
    backward): a layer's decay w (B T D / M) and ``u``, ``lnx``,
    ``lnx_b`` (D / M each)."""
    cfg = tconfigs.get("rwkv6-7b").reduced(n_layers=2, d_model=512)
    L_, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    M = 16
    assert D // cfg.rwkv_head_size == 16 and cfg.dtype == torch.float32
    mesh = mesh_mod.make_production_mesh()
    Bl, T = 2, 8
    shape = tshapes.InputShape("train_small", T, 16 * Bl, "train")
    rec = dryrun.dry_train(cfg, shape, mesh, placement="tp")
    isz, BT = 4, Bl * T                        # f32
    want = {"all-reduce": isz * BT * (L_ * (7 * D + F) + 2 * D + 2),
            "all-reduce-max": isz * BT,
            "all-gather": L_ * isz * BT * (F + D) // M,
            "all-gather-grad": L_ * isz * (BT * D + 3 * D) // M}
    assert rec["tp_breakdown"] == want
    assert rec["tp_bytes"] == sum(want.values())
    assert rec["state_bytes_per_rank"] == rec["state_bytes_per_model_shard"]


def test_tp_one_process_dry_step_equals_the_real_cpu_step():
    """``StackedTP`` on the golden (4, 2) spec's model, dry on ``meta``
    and real on the CPU: the same TP bytes and ``pp`` bytes, call for
    call (the products differ from the card's kernels' outputs only in
    values)."""
    from repro_torch.models.tp import StackedTP
    cfg = _small_cfg()
    mesh = mesh_mod.Mesh((4, 2))
    spec = _spec(cfg, mesh)
    runner = tapi.build_trainer_runner(spec, device="cpu", model_cfg=cfg,
                                       tp=StackedTP(2))
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, s, generator=g)
             for k, (s, _) in tshapes.train_input_specs(
                 cfg, SMALL_SHAPE, spec.n_nodes).items()}
    real, _, _, _ = dryrun.counted_step(
        runner.trainer, [runner.init_state()], batch,
        GeneratorDraws(0, "cpu"))
    tr, placement = dryrun.meta_trainer(spec, mesh, cfg, "tp one process")
    assert placement == "tp one process"
    mbatch = {k: torch.empty(v.shape, dtype=v.dtype, device=META)
              for k, v in batch.items()}
    dry, _, _, _ = dryrun.counted_step(tr, [tr.abstract_state()], mbatch)
    assert dry.tp == real.tp and sum(real.tp.values()) > 0
    assert dry.coll == real.coll
    assert dry.flops == real.flops
