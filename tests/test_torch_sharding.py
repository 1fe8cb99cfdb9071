"""The port's model sharding (``repro_torch.models.sharding``) and its
meshes (``repro_torch.launch.mesh``) against ``repro.models.sharding`` and
``repro.launch.mesh``.

* For each of the ten architectures at ``.reduced()``: every leaf's path
  (``tree.flatten_with_paths`` against the reference's ``_path_str`` of
  ``tree_flatten_with_path``), partition spec (``param_specs``, entry for
  entry), ``model_local_shape`` and ``shard_dim_ok`` at M = 2 and 16 equal
  the reference's.
* ``spec_for_path``'s rank adjustments (a leaf with more dims than its
  rule, with fewer, a path no rule matches) equal the reference's.
* A node-stacked leaf cut into its model shards (``shard_view``) holds,
  shard m, the m-th slice of the dim its spec shards, and
  ``join_shards`` gives the leaf back bit for bit; the same with an Hw
  slot dim in front.
* The logical meshes: ``node_axes`` and ``model_axis_size`` equal the
  reference's on its (1, 1) mesh of the one CPU device; the production
  shapes; ``ProcessMesh``'s node blocks and its refusal.
"""
import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro import configs as jconfigs
from repro.models import sharding as jsh
from repro.models import transformer as JTR
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as TTR

ARCHS = list(tconfigs.ARCH_IDS)


def _reference_leaves(arch):
    """[(path, shape, spec entries)] of the reference's reduced model."""
    ap = JTR.abstract_params(jconfigs.get(arch).reduced())
    specs = jax.tree_util.tree_leaves(
        jsh.param_specs(ap), is_leaf=lambda s: isinstance(s, jsh.P))
    paths = jax.tree_util.tree_flatten_with_path(ap)[0]
    return [(jsh._path_str(p), tuple(leaf.shape), tuple(sp))
            for (p, leaf), sp in zip(paths, specs, strict=True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_local_shapes_equal_the_reference(arch):
    want = _reference_leaves(arch)
    params = TTR.abstract_params(tconfigs.get(arch).reduced())
    specs = tree.leaves(tsh.param_specs(params))
    got = [(path, tuple(leaf.shape), sp) for (path, leaf), sp in zip(
        tree.flatten_with_paths(params), specs, strict=True)]
    assert len(got) == len(want)
    assert any(tsh.spec_mentions(sp, "model") for _, _, sp in got)
    for (path, shape, sp), (jpath, jshape, jsp) in zip(got, want):
        assert (path, shape, sp.entries) == (jpath, jshape, jsp)
        assert isinstance(sp, tsh.PartitionSpec)
        assert tsh.spec_mentions(sp, "model") == \
            jsh.spec_mentions(jsh.P(*jsp), "model")
        for m in (2, 16):
            assert tsh.model_local_shape(shape, sp, m) == \
                jsh.model_local_shape(shape, jsh.P(*jsp), m), (path, m)
            assert tsh.shard_dim_ok(shape, sp, {"model": m}) == \
                jsh.shard_dim_ok(shape, jsh.P(*jsp), {"model": m}), (path, m)
    # the node axis prepended, as the trainer's state specs carry it
    pre = tree.leaves(tsh.param_specs(params, prepend=(("pod", "data"),)))
    assert all(p.entries == (("pod", "data"),) + s.entries
               for p, s in zip(pre, specs))


@pytest.mark.parametrize("path,ndim", [
    ("blocks/wq", 3), ("blocks/wq", 2), ("blocks/wq", 4), ("embed", 2),
    ("blocks/wo", 3), ("blocks/experts_down", 4), ("blocks/q_norm", 2),
    ("xblocks/cross_wk", 3), ("lm_head", 2), ("blocks/rg_w_out", 3)])
def test_spec_for_path_rank_adjustments(path, ndim):
    assert tsh.spec_for_path(path, ndim).entries == \
        tuple(jsh.spec_for_path(path, ndim))


def test_wo_shards_dim_1_and_embed_dim_0():
    """Non-last sharded dims: ``wo`` (L, H hd, D) halves dim 1, the
    embedding (V, D) dim 0, the last dims stay."""
    sp_wo = tsh.spec_for_path("blocks/wo", 3)
    assert tsh.model_local_shape((2, 128, 64), sp_wo, 2) == (2, 64, 64)
    assert tsh.model_dim(sp_wo) == 1
    sp_e = tsh.spec_for_path("embed", 2)
    assert tsh.model_local_shape((19200, 2048), sp_e, 2) == (9600, 2048)
    assert tsh.model_dim(tsh.spec_for_path("blocks/q_norm", 2)) is None
    with pytest.raises(ValueError, match="model axis on dims"):
        tsh.model_dim(tsh.P("model", "model"))


@pytest.mark.parametrize("M", [2, 4])
def test_shard_view_and_join_round_trip(M):
    cfg = tconfigs.get("qwen3-1.7b").reduced(n_layers=2, d_model=64)
    params = TTR.abstract_params(cfg)
    g = torch.Generator().manual_seed(0)
    N = 3
    for (path, leaf), sp in zip(tree.flatten_with_paths(params),
                                tree.leaves(tsh.param_specs(params))):
        x = torch.randn((N,) + tuple(leaf.shape), generator=g)
        v = tsh.shard_view(x, sp, M)
        d = tsh.model_dim(sp)
        local = tsh.model_local_shape(tuple(leaf.shape), sp, M)
        if d is None:
            assert v.shape == (N, 1) + tuple(leaf.shape)
        else:
            assert v.shape == (N, M) + local
            for m in range(M):
                want = x.narrow(1 + d, m * local[d], local[d])
                assert torch.equal(v[:, m], want), (path, m)
        assert v.data_ptr() == x.data_ptr() or d is None
        back = tsh.join_shards(v.contiguous(), sp)
        assert torch.equal(back, x), path
        # an Hw leaf: the slot dim T between the node and the leaf dims
        hw = torch.randn((N, 2) + tuple(leaf.shape), generator=g)
        hv = tsh.shard_view(hw, sp, M, lead=2)
        assert torch.equal(tsh.join_shards(hv.contiguous(), sp, lead=2), hw)
        before = hw.clone()
        hv.mul_(2)                    # a view: writes reach the leaf
        assert torch.equal(hw, 2 * before)


def test_meshes_match_the_reference():
    jmesh = compat.make_mesh((1, 1), ("data", "model"))
    tm = tmesh.Mesh((1, 1))
    assert tsh.node_axes(tm) == jsh.node_axes(jmesh) == ("data",)
    assert tsh.model_axis_size(tm) == jsh.model_axis_size(jmesh) == 1
    assert tsh.model_axis_size(None) == 1
    assert tsh.model_axis_size(tmesh.Mesh((4, 2))) == 2
    pod = tmesh.make_production_mesh()
    assert (pod.shape, pod.axis_names) == ((16, 16), ("data", "model"))
    assert (pod.n_nodes, pod.n_chips) == (16, 256)
    two = tmesh.make_production_mesh(multi_pod=True)
    assert two.axis_names == ("pod", "data", "model")
    assert (two.n_nodes, two.n_chips) == (32, 512)
    assert tsh.node_axes(two) == ("pod", "data")
    assert tsh.constrain(torch.ones(2), tsh.P("model")).sum() == 2
    with pytest.raises(ValueError, match="differ in rank"):
        tmesh.Mesh((4, 2), ("data",))


def test_process_mesh_blocks():
    m = tmesh.Mesh((8, 2))
    blocks = [tmesh.ProcessMesh(m, rank=r, world=4) for r in range(4)]
    assert [(b.lo, b.hi) for b in blocks] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [blocks[0].owner(n) for n in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    x = torch.arange(8)
    assert torch.equal(blocks[2].rows(x), torch.tensor([4, 5]))
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.ProcessMesh(m, rank=0, world=3)
    with pytest.raises(ValueError, match="outside world"):
        tmesh.ProcessMesh(m, rank=4, world=4)


def test_build_refuses_a_leaf_that_does_not_split():
    """A model axis that does not divide a sharded dim is refused at
    build, naming the leaf (the reference's ``shard_dim_ok``)."""
    from repro_torch.optim.decentralized import (DecentralizedTrainer,
                                                 TrainerConfig)
    cfg = tconfigs.get("qwen3-1.7b").reduced(n_layers=1, d_model=64)
    tcfg = TrainerConfig(n_nodes=4, backend="neighbor")
    with pytest.raises(ValueError, match=r"leaf blocks/w_down \(1, 128, "
                       r"64\) does not split into 7 model shards"):
        DecentralizedTrainer(cfg, tcfg, device="cpu",
                             mesh=tmesh.Mesh((4, 7)))
    tr = DecentralizedTrainer(cfg, tcfg, device="cpu",
                              mesh=tmesh.Mesh((4, 2)))
    assert tr.model_shards == 2 and np.array_equal(
        [tsh.spec_mentions(s, "model") for s in tr.leaf_specs],
        tr.model_sharded_leaf)
