"""The port's QInf kernels (B1 quantize, B2 dequantize) against the JAX
package: plain versions against ``repro.kernels.ref`` and the Pallas kernels
(interpret mode), and the last-dim wrappers against ``repro.kernels.ops``.

Codes and scales must agree bit for bit given the same x and noise u; the
noise is drawn by JAX and handed to the port.  The CUDA kernels themselves
run only on the card, where they are held against the plain versions; a
machine with a card but without JAX runs just those:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as kops
    from repro.kernels import quantize as qk
    from repro.kernels import ref as kref
except ImportError:        # no JAX: only the cuda tests can run
    jax = None

from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
_JDT = ({"f32": jnp.float32, "bf16": jnp.bfloat16, "f64": jnp.float64}
        if jax is not None else {})


def _to_torch(a, dtype) -> torch.Tensor:
    """A JAX array -> torch, exactly (bf16 travels through f32)."""
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(a.copy()).to(dtype)


def _x_u(rows, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(rows, 256)) * 3).astype(_JDT[dtype])
    u = jnp.asarray(rng.random((rows, 256)), jnp.float32)
    return x, u


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("rows", [8, 16, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_blocks_match_reference(bits, rows, dtype):
    """Plain B1/B2 against repro.kernels.ref: bit-exact codes, scales and
    dequantized output in every output dtype."""
    x, u = _x_u(rows, dtype, seed=bits * 100 + rows)
    cr, sr = kref.qinf_quantize_blocks_ref(x, u, bits)
    ct, st = tq.qinf_quantize_blocks(_to_torch(x, _TDT[dtype]),
                                     _to_torch(u, torch.float32), bits)
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
    for out in ("f32", "bf16", "f64"):
        dr = kref.qinf_dequantize_blocks_ref(cr, sr, _JDT[out])
        dt = tq.qinf_dequantize_blocks(ct, st, _TDT[out])
        assert dt.dtype == _TDT[out]
        np.testing.assert_array_equal(dt.to(torch.float64).numpy(),
                                      np.asarray(dr.astype(jnp.float64)))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_blocks_match_pallas_kernels(bits, dtype):
    """Plain B1/B2 against the Pallas kernels themselves (interpret mode)."""
    x, u = _x_u(16, dtype, seed=bits)
    ck, sk = qk.qinf_quantize_blocks(x, u, bits=bits, block=256,
                                     interpret=True)
    ct, st = tq.qinf_quantize_blocks(_to_torch(x, _TDT[dtype]),
                                     _to_torch(u, torch.float32), bits)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(ck))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sk))
    dk = qk.qinf_dequantize_blocks(ck, sk, block=256, interpret=True)
    np.testing.assert_array_equal(
        tq.qinf_dequantize_blocks(ct, st).numpy(), np.asarray(dk))


def test_zero_row_and_code_range():
    x = np.linspace(-4, 4, 8 * 256).reshape(8, 256)
    x[3] = 0.0
    u = np.zeros((8, 256), np.float32)
    c, s = tq.qinf_quantize_blocks(torch.tensor(x, dtype=torch.float32),
                                   torch.from_numpy(u), 3)
    assert int(c.abs().max()) <= 4
    assert float(s[3, 0]) == 0.0 and int(c[3].abs().max()) == 0
    cr, sr = kref.qinf_quantize_blocks_ref(jnp.asarray(x, jnp.float32),
                                           jnp.asarray(u), 3)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


def test_wrappers_validate():
    x = torch.zeros((8, 256))
    with pytest.raises(ValueError):
        tq.qinf_quantize_blocks(x, torch.zeros((8, 128)), 2)
    with pytest.raises(ValueError):
        tq.qinf_quantize_blocks(x, torch.zeros((8, 256)), 8)
    with pytest.raises(ValueError):
        tq.qinf_dequantize_blocks(torch.zeros((8, 256), dtype=torch.int8),
                                  torch.zeros((8,)))


def test_cpu_path_launches_nothing():
    tq.reset_launch_counts()
    c, s = tq.qinf_quantize_blocks(torch.ones((8, 256)),
                                   torch.zeros((8, 256)), 2)
    tq.qinf_dequantize_blocks(c, s)
    assert tq.launch_counts() == {"qinf_quantize_blocks": 0,
                                  "qinf_dequantize_blocks": 0,
                                  "qinf_quantize_pack_blocks": 0,
                                  "qinf_unpack_dequant_mix_blocks": 0}


@pytest.mark.parametrize("shape,bits,block", [
    ((), 2, 256), ((5,), 2, 256), ((1000,), 4, 256), ((3, 7, 11), 2, 256),
    ((256,), 1, 256), ((2, 256), 2, 256), ((8, 256), 2, 256),
    ((129,), 7, 256), ((4, 300), 2, 256), ((3, 7, 11), 1, 8),
    ((129,), 4, 8), ((4, 300), 3, 8)])
def test_lastdim_matches_reference_ops(shape, bits, block):
    rng = np.random.default_rng(len(shape) * 31 + bits)
    x = jnp.asarray(rng.normal(size=shape) * 2, jnp.float32)
    key = jax.random.key(bits)
    cj, sj = kops.qinf_quantize_lastdim(x, key, bits=bits, block=block)
    # the noise the reference drew internally, handed to the port
    u = jax.random.uniform(key, kops.blockwise_lastdim(x, block=block).shape,
                           jnp.float32)
    assert tops.blockwise_shape(shape, block) == u.shape
    ct, st = tops.qinf_quantize_lastdim(_to_torch(x, torch.float32),
                                        _to_torch(u, torch.float32),
                                        bits=bits, block=block)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for dt in ("f32", "f64"):
        oj = kops.qinf_dequantize_lastdim(cj, sj, shape, _JDT[dt],
                                          block=block)
        ot = tops.qinf_dequantize_lastdim(ct, st, shape, _TDT[dt],
                                          block=block)
        assert tuple(ot.shape) == tuple(shape) and ot.dtype == _TDT[dt]
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_padded_tail_decodes_to_zero():
    x = torch.ones((300,))
    u = torch.from_numpy(np.random.default_rng(0).random((2, 256))
                         .astype(np.float32))
    c, s = tops.qinf_quantize_lastdim(x, u, bits=2, block=256)
    assert int(c[1, 44:].abs().max()) == 0
    full = tq.qinf_dequantize_blocks(c, s)
    assert float(full[1, 44:].abs().max()) == 0.0
    out = tops.qinf_dequantize_lastdim(c, s, (300,), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.ones(300), atol=1e-6)


def test_wire_halves_pack_roundtrip_matches_reference():
    rng = np.random.default_rng(0)
    for bits in (1, 2, 3, 4, 7):
        lim = 2 ** (bits - 1)
        codes = rng.integers(-lim, lim + 1, size=(5, 16)).astype(np.int8)
        pj = kref.pack_codes_halves_ref(jnp.asarray(codes), bits)
        pt = tref.pack_codes_halves_ref(torch.from_numpy(codes), bits)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(
            tref.unpack_codes_halves_ref(pt, bits).numpy(), codes)


@pytest.mark.parametrize("bits", [2, 4])
def test_wire_quantize_pack_and_mix_match_reference(bits):
    """The wire-path plain versions (of kernels B3/B4): packed bytes and
    scales exact, the f32 mix to a stated 1e-6 relative (the port sums the
    senders in order, the reference contracts them with a dot)."""
    x, u = _x_u(6, "f32", seed=bits)
    pj, sj = kref.qinf_quantize_pack_blocks_ref(x, u, bits)
    pt, st = tref.qinf_quantize_pack_blocks_ref(_to_torch(x, torch.float32),
                                                _to_torch(u, torch.float32),
                                                bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    packed = np.stack([np.asarray(pj)] * 3)              # (S=3, R, W)
    scales = np.stack([np.asarray(sj) * (s + 1) for s in range(3)])
    w = np.array([[0.5, 0.25, 0.25], [1 / 3, 1 / 3, 1 / 3]], np.float32)
    mj, qj = kref.qinf_unpack_dequant_mix_blocks_ref(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(w), bits)
    mt, qt = tref.qinf_unpack_dequant_mix_blocks_ref(      # one node
        torch.from_numpy(packed)[None], torch.from_numpy(scales)[None],
        torch.from_numpy(w)[None], bits)
    np.testing.assert_array_equal(qt[0].numpy(), np.asarray(qj))
    np.testing.assert_allclose(mt[0].numpy(), np.asarray(mj), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_kernels_match_plain(bits, dtype):
    """B1/B2 on the card against their plain versions on the same inputs:
    codes, scales and dequantized output exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(bits)
    x = (torch.randn((8 * 31, 256), generator=g, device="cuda") * 3).to(dtype)
    x[5] = 0
    u = torch.rand((8 * 31, 256), generator=g, device="cuda")
    before = tq.launch_counts()
    ck, sk = tq.qinf_quantize_blocks(x, u, bits)
    cr, sr = tref.qinf_quantize_blocks_ref(x, u, bits)
    assert torch.equal(ck, cr) and torch.equal(sk, sr)
    for out in (torch.float32, torch.bfloat16, torch.float64):
        assert torch.equal(tq.qinf_dequantize_blocks(ck, sk, out),
                           tref.qinf_dequantize_blocks_ref(cr, sr, out))
    after = tq.launch_counts()
    assert after["qinf_quantize_blocks"] == before["qinf_quantize_blocks"] + 1
    assert after["qinf_dequantize_blocks"] == \
        before["qinf_dequantize_blocks"] + 3
