"""The plain reference agrees with the port at a small size on the CPU:
each node's loss and gradient, QInf's dequantized payload, the mixing
matrices, and the bits a node sends."""
import pytest
import torch

import bench_small
from perfbench import harness, traffic
from perfbench.reference import common as RC
from perfbench.reference import proxlead

BENCH = traffic.benchmark()


def _small_cell(name):
    return bench_small.small_cell(name)


@pytest.mark.parametrize("name", ["qwen3-1.7b.ring8",
                                  "whisper-large-v3.ring8"])
def test_each_nodes_loss_and_gradient_match_the_port(name):
    torch.manual_seed(0)
    cell = _small_cell(name)
    dev = torch.device("cpu")
    prog = harness.Program(cell, dev)
    X0 = traffic.make_weights(cell.leaves, 5, dev)
    # every node its own replica, so each node's gradient is its own
    Xs = [x[None] + 0.01 * torch.randn((cell.cell["nodes"],) + x.shape)
          for x in X0]
    batch = traffic.make_bank(cell.cell, cell.cfg, 5, dev)[0]
    tr = prog.runner.trainer
    ce, G = tr.loss_and_grad(harness.nested(cell.paths, Xs), batch)
    G = prog.tree.leaves(G)
    for n in range(cell.cell["nodes"]):
        p = {path: x[n].clone().requires_grad_(True)
             for path, x in zip(cell.paths, Xs)}
        loss = cell.model.node_loss(cell.cfg, RC.Precision(), p,
                                    {k: v[n] for k, v in batch.items()})
        g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        # a leaf whose gradient is nought to rounding (a key bias under
        # the softmax) is held at a thousandth of the largest leaf's scale
        top = max(float(gp[n].abs().max()) for gp in G)
        for j, (gr, gp) in enumerate(zip(g, G)):
            gr = torch.zeros_like(gp[n]) if gr is None else gr
            scale = max(float(gp[n].abs().max()), 1e-3 * top)
            assert float((gr - gp[n]).abs().max()) <= 1e-4 * scale, \
                cell.paths[j]


def test_qinf_matches_the_ports_plain_kernel():
    from repro_torch.kernels import ref as kref
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 5, 64), generator=g)
    u = torch.rand((3, 5, 4, 16), generator=g)
    q = proxlead.qinf(x, u, 2)
    codes, scales = kref.qinf_quantize_blocks_ref(x.reshape(-1, 16),
                                                  u.reshape(-1, 16), 2)
    want = kref.qinf_dequantize_blocks_ref(codes, scales).reshape(x.shape)
    assert torch.equal(q, want)


def test_mixing_matrices_match_the_ports_graphs():
    from repro_torch.core import topology
    for name in ("ring", "exponential"):
        assert (abs(proxlead.GRAPHS[name](8)
                    - topology.make_topology(name, 8).W)).max() < 1e-15


def test_noise_drawn_into_a_strided_view_is_the_contiguous_draw():
    table = torch.zeros((4, 10, 16))
    view = table[:, 3:7].view(4, 2, 2, 16)
    traffic.noise(9, 4, tuple(view.shape), "cpu", out=view)
    assert torch.equal(view, traffic.noise(9, 4, tuple(view.shape), "cpu"))


@pytest.mark.cuda
def test_noise_drawn_into_a_strided_view_is_the_contiguous_draw_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the qwen3 slice's row table: a leaf's view of it spans 5 GiB
    table = torch.zeros((8, 700_456, 256), device="cuda")
    view = table[:, 4:4 + 614_400].view(8, 2, 2048, 150, 256)
    traffic.noise(9, 4, tuple(view.shape), "cuda", out=view)
    assert torch.equal(view, traffic.noise(9, 4, tuple(view.shape), "cuda"))


def test_payload_bits_match_the_ports_count():
    cell = harness.open_cell("qwen3-1.7b.ring8", BENCH)
    prog = harness.Program(cell, torch.device("cpu"))
    want = prog.runner.bits_per_step()
    bits = proxlead.payload_bits([s["shape"] for _, s in cell.leaves], 2,
                                 256)
    assert harness._union_hops(cell.cell) * bits == want
