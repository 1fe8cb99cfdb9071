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
        tq.qinf_quantize_blocks(x, torch.zeros((8, 256)), 9)
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
                                  "qinf_unpack_dequant_mix_blocks": 0,
                                  "proxlead_head": 0, "proxlead_tail": 0}


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


# ---------------------------------------------------------------------------
# The launch path and B2's variant choice (host-side logic, on the CPU).
# ---------------------------------------------------------------------------

def test_c_constants_match_the_wrapper():
    """The dtype tags and the kernel names are written in csrc/ and in
    quantize.py; they must agree."""
    import re
    csrc = tq.SOURCES["qinf"].parent
    common = (csrc / "common.cuh").read_text()
    kernels = "".join(src.read_text() for name, src in tq.SOURCES.items()
                      if name != "binding")
    binding = tq.SOURCES["binding"].read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert {torch.float32: const(common, "kF32"),
            torch.float64: const(common, "kF64"),
            torch.bfloat16: const(common, "kBF16")} == tq._DTYPE_TAG
    assert "tag == 1 ? at::kDouble : tag == 2 ? at::kBFloat16 : at::kFloat" \
        in binding
    assert set(re.findall(r'\{"((?:qinf|proxlead)_\w+)"', binding)) == \
        set(tq.LAUNCHES) | set(tq._ENTRIES)
    assert set(tq._ENTRIES.values()) <= set(tq.LAUNCHES)
    for kernel in tq.LAUNCHES:
        assert f"int {kernel}_launch(" in kernels
    for header in tq.HEADERS:
        assert header.is_file()


def test_vector_queries_match_the_sources():
    """Every variant query the wrapper loads (``<kernel>_vector``, one a
    QInf kernel; ``proxlead_vector``, the one rule of B5 and B6) is a C
    function of the kernel sources, and each launcher takes the variant
    its query names."""
    import inspect
    import re
    kernels = "".join(src.read_text() for name, src in tq.SOURCES.items()
                      if name != "binding")
    loaded = set(re.findall(r"\.((?:qinf|proxlead)\w*_vector)\.argtypes",
                            inspect.getsource(tq._libs)))
    query_of = {k: "proxlead_vector" if k.startswith("proxlead_")
                else f"{k}_vector" for k in tq.LAUNCHES}
    assert loaded == set(query_of.values())
    for kernel, query in query_of.items():
        assert f"int {query}(" in kernels
        launcher = kernels[kernels.index(f"int {kernel}_launch("):]
        assert f"{query}(" in launcher[:launcher.index("\n}\n")]


def test_launch_helper_counts_only_launches(monkeypatch):
    """_launch hands its arguments to the binding call and returns its
    outputs; it counts a launch, not a call the binding refuses (inputs
    the kernel does not take) nor one that raises a CUDA error."""
    calls = []

    def fake(*args):
        calls.append(args)
        return "outputs"

    def failing(*args):
        raise RuntimeError("qinf_dequantize_blocks launch failed: CUDA "
                           "error 700 (an illegal memory access)")

    monkeypatch.setattr(tq, "_LAUNCHERS", {"qinf_dequantize_blocks": fake})
    tq.reset_launch_counts()
    assert tq._launch("qinf_dequantize_blocks", 11, 22) == "outputs"
    assert calls == [(11, 22)]
    assert tq.launch_counts()["qinf_dequantize_blocks"] == 1
    def refusing(*args):
        raise TypeError("kernel takes int8 codes, f32 scales and an output "
                        "tag 0 (f32), 1 (f64) or 2 (bf16), got Float, Float "
                        "and 0")

    monkeypatch.setattr(tq, "_LAUNCHERS", {"qinf_dequantize_blocks": refusing})
    with pytest.raises(TypeError, match="int8 codes"):
        tq._launch("qinf_dequantize_blocks", 11, 22)
    monkeypatch.setattr(tq, "_LAUNCHERS", {"qinf_dequantize_blocks": failing})
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tq._launch("qinf_dequantize_blocks", 11, 22)
    assert tq.launch_counts()["qinf_dequantize_blocks"] == 1
    tq.reset_launch_counts()


class _Elsewhere(torch.Tensor):
    """A CPU tensor that says it lies on another device than the CPU, the
    card or ``meta``."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t):
    return torch.Tensor._make_subclass(_Elsewhere, t)


def test_wrappers_refuse_other_devices_and_launch_nothing():
    """A tensor that is neither on the card, nor on the CPU, nor on
    ``meta`` raises; a ``meta`` tensor takes the card's route dry (its
    outputs on ``meta``, counted in META_CALLS, no launch); the CPU path
    never reaches a launcher."""
    x = _elsewhere(torch.zeros((8, 256)))
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qinf_quantize_blocks(x, _elsewhere(torch.zeros((8, 256))), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qinf_dequantize_blocks(_elsewhere(torch.zeros((8, 256),
                                                         dtype=torch.int8)),
                                  _elsewhere(torch.zeros((8, 1))))
    tq.reset_launch_counts()
    tq.reset_meta_calls()
    meta = torch.empty((8, 256), device="meta")
    codes, scales = tq.qinf_quantize_blocks(
        meta, torch.empty((8, 256), device="meta"), 2)
    out = tq.qinf_dequantize_blocks(codes, scales)
    assert codes.is_meta and scales.shape == (8, 1) and out.is_meta
    assert sum(tq.launch_counts().values()) == 0
    assert tq.meta_call_counts()["qinf_quantize_blocks"] == \
        tq.meta_call_counts()["qinf_dequantize_blocks"] == 1
    for block in (256, 100, 3):
        codes = torch.randint(-2, 3, (5, block), dtype=torch.int8)
        out = tq.qinf_dequantize_blocks(codes[1:], torch.ones((4, 1)))
        assert torch.equal(out, codes[1:].float())
    assert sum(tq.launch_counts().values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("block,offset_rows,vector", [
    (256, 0, True), (128, 0, True), (100, 0, False), (3, 0, False),
    (100, 1, False), (256, 1, True)])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16,
                                 torch.float64])
def test_cuda_dequantize_variants_match_plain(block, offset_rows, vector,
                                              out):
    """B2's vector and row variants on the card against the plain version:
    widths 256 and 128 (vector), 100 and 3 (row), and a contiguous view
    one row into its buffer (width 100 breaks the 16-byte alignment, width
    256 keeps it).  Outputs exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(block)
    R = 8 * 31 + 5
    buf = torch.randint(-4, 5, (R + offset_rows, block), generator=g,
                        device="cuda", dtype=torch.int8)
    codes = buf[offset_rows:]
    scales = torch.rand((R, 1), generator=g, device="cuda") * 3
    scales[7] = 0
    before = tq.launch_counts()["qinf_dequantize_blocks"]
    got = tq.qinf_dequantize_blocks(codes, scales, out)
    assert tq.uses_vector_variant("qinf_dequantize_blocks", codes.data_ptr(),
                                  got.data_ptr(), block) is vector
    assert torch.equal(got, tref.qinf_dequantize_blocks_ref(codes, scales,
                                                            out))
    assert tq.launch_counts()["qinf_dequantize_blocks"] == before + 1


@pytest.mark.cuda
def test_cuda_binding_names_each_fault():
    """On the card the binding alone checks the inputs: a wrong shape,
    bits, dtype, output dtype, device or layout raises the error that
    names it, and nothing launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = torch.zeros((8, 256), device="cuda")
    codes = torch.zeros((8, 256), dtype=torch.int8, device="cuda")
    scales = torch.ones((8, 1), device="cuda")
    before = tq.launch_counts()
    with pytest.raises(ValueError, match="noise shape"):
        tq.qinf_quantize_blocks(x, x[:, :128].contiguous(), 2)
    with pytest.raises(ValueError, match="bits must be in 1..8"):
        tq.qinf_quantize_blocks(x, x, 9)
    with pytest.raises(TypeError, match="x f32/f64/bf16 and u f32"):
        tq.qinf_quantize_blocks(x.half(), x, 2)
    with pytest.raises(ValueError, match="contiguous on one CUDA device"):
        tq.qinf_quantize_blocks(x, x.cpu(), 2)
    with pytest.raises(ValueError, match="contiguous on one CUDA device"):
        tq.qinf_quantize_blocks(x.t().contiguous().t(), x, 2)
    with pytest.raises(ValueError, match="scales \\(R, 1\\)"):
        tq.qinf_dequantize_blocks(codes, scales[:4])
    with pytest.raises(TypeError, match="int8 codes"):
        tq.qinf_dequantize_blocks(codes.float(), scales)
    with pytest.raises(TypeError, match="int8 codes"):
        tq.qinf_dequantize_blocks(codes, scales, torch.float16)
    with pytest.raises(ValueError, match="contiguous on one CUDA device"):
        tq.qinf_dequantize_blocks(codes, scales.cpu())
    with pytest.raises(ValueError, match="contiguous on one CUDA device"):
        tq.qinf_dequantize_blocks(codes[:, ::2], scales)
    assert tq.launch_counts() == before


# ---------------------------------------------------------------------------
# B1 on a whole leaf: the card route of ops.qinf_quantize_lastdim hands the
# unpadded leaf and its blocked noise to the kernel, which reads the ragged
# last block in place.
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card tensor does: what
    the wrappers route on."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("shape,block", [
    ((8, 7840), 256), ((3, 7, 11), 256), ((129,), 256), ((), 256),
    ((5, 129), 128), ((4, 300), 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64, torch.float16])
def test_lastdim_card_route_hands_the_leaf_to_b1(monkeypatch, shape, block,
                                                 dtype):
    """On the card route the leaf goes to _launch("qinf_quantize_blocks")
    unpadded, unreshaped and, for the dtypes the kernel reads, uncast (any
    other dtype as f32, what the plain path reads), with the blocked noise
    as drawn; nothing is padded and the launcher's outputs come back."""
    calls = []

    def fake(*args):
        calls.append(args)
        return "codes", "scales"

    def no_pad(*args, **kwargs):
        raise AssertionError("the card route pads nothing")

    monkeypatch.setattr(tq, "_LAUNCHERS", {"qinf_quantize_blocks": fake})
    monkeypatch.setattr(tops, "blockwise_lastdim", no_pad)
    tq.reset_launch_counts()
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(3))
         .to(dtype).as_subclass(_OnCard))
    u = torch.rand(tops.blockwise_shape(shape, block))
    assert tops.qinf_quantize_lastdim(x, u, bits=3, block=block) == (
        "codes", "scales")
    (xa, ua, bits), = calls
    assert ua is u and bits == 3
    if dtype == torch.float16:
        assert xa.dtype == torch.float32 and xa.shape == x.shape
        assert torch.equal(xa.as_subclass(torch.Tensor),
                           x.as_subclass(torch.Tensor).float())
    else:
        assert xa is x
    assert tq.launch_counts()["qinf_quantize_blocks"] == 1
    tq.reset_launch_counts()


@pytest.mark.parametrize("bad", [(8, 31, 128), (8, 7936), (248, 256)])
def test_lastdim_card_route_refuses_noise_of_another_block(monkeypatch, bad):
    """A noise whose last axis is not the block, or which is not blocked
    (one axis more than the leaf), raises before any launch."""
    monkeypatch.setattr(tq, "_LAUNCHERS", {"qinf_quantize_blocks": None})
    tq.reset_launch_counts()
    x = torch.zeros((8, 7840)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="noise shape"):
        tops.qinf_quantize_lastdim(x, torch.zeros(bad), block=256)
    assert sum(tq.launch_counts().values()) == 0


@pytest.mark.parametrize("shape,block", [
    ((8, 7840), 256), ((3, 7, 11), 256), ((129,), 256), ((), 256),
    ((5, 129), 128), ((4, 300), 8), ((2, 3, 520), 256)])
def test_lastdim_cpu_route_keeps_the_blocked_shapes(shape, block):
    """The CPU route is unchanged: codes in the blocked shape, scales with
    its last axis 1, the padded tail's codes 0, equal to the plain version
    on the zero-padded rows."""
    g = torch.Generator().manual_seed(len(shape) + block)
    x = torch.randn(shape, generator=g) * 3
    want = tops.blockwise_shape(shape, block)
    u = torch.rand(want, generator=g)
    codes, scales = tops.qinf_quantize_lastdim(x, u, bits=2, block=block)
    assert tuple(codes.shape) == want and codes.dtype == torch.int8
    assert tuple(scales.shape) == want[:-1] + (1,)
    D = shape[-1] if shape else 1
    tail = -D % block
    if tail:
        assert int(codes[..., -1, block - tail:].abs().max()) == 0
    cr, sr = tref.qinf_quantize_blocks_ref(
        tops.blockwise_lastdim(x, block=block).reshape(-1, block),
        u.reshape(-1, block), 2)
    assert torch.equal(codes.reshape(-1, block), cr)
    assert torch.equal(scales.reshape(-1, 1), sr)


@pytest.mark.parametrize("bad", [(8, 30, 256), (8, 31, 128), (248, 256),
                                 (8, 7840)])
def test_lastdim_cpu_route_refuses_a_noise_of_another_shape(bad):
    with pytest.raises(ValueError, match="noise shape"):
        tops.qinf_quantize_lastdim(torch.zeros((8, 7840)), torch.zeros(bad),
                                   block=256)


# (label, leaf shape, block, storage offset in elements, row stride or None,
# first zeroed element of the last axis or None, B1 takes its vector
# variant): the cases of chip_smoke.py's phase 3.  Vector: rows whose every
# block starts 16-byte aligned, blocks of at most 1024 elements; row: rows
# that break the alignment, a view off it, a block wider than 1024.
_B1_CASES = [
    ("main", (8, 7840), 256, 0, None, None, True),
    ("block128", (8, 7840), 128, 0, None, None, True),
    ("ragged1d", (129,), 256, 0, None, None, True),
    ("zero_tail", (4, 320), 256, 0, None, 256, True),
    ("row_stride", (8, 7840), 256, 0, 8000, None, True),
    ("ragged3d", (3, 7, 11), 256, 0, None, None, False),
    ("unaligned_rows", (5, 129), 256, 0, None, None, False),
    ("offset_view", (8, 7840), 256, 1, None, None, False),
    ("wide_block", (8, 7840), 2048, 0, None, None, False),
]


def _b1_leaf(shape, offset, row_stride, zero_from, dtype, g):
    """A leaf of ``shape`` on the card: ``offset`` elements into its
    buffer, rows ``row_stride`` apart (a view of wider rows), its last axis
    zero from ``zero_from`` on."""
    D = shape[-1]
    lead = shape[:-1]
    width = row_stride or D
    n = offset + int(np.prod(lead, dtype=np.int64)) * width
    buf = (torch.randn(n, generator=g, device="cuda") * 3).to(dtype)
    x = buf[offset:].view(*lead, width)[..., :D]
    if zero_from is not None:
        x[..., zero_from:] = 0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,block,offset,row_stride,zero_from,vector",
                         _B1_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_lastdim_matches_plain(label, shape, block, offset, row_stride,
                                    zero_from, vector, dtype):
    """B1 on a leaf, its ragged last block read in place, against the
    plain version on the zero-padded rows, bits 1-7: codes and scales
    exactly equal, in the blocked shapes; each case takes the variant it
    names, and each call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(len(label))
    x = _b1_leaf(shape, offset, row_stride, zero_from, dtype, g)
    u = torch.rand(tops.blockwise_shape(shape, block), generator=g,
                   device="cuda")
    assert tq.uses_vector_variant("qinf_quantize_blocks", x, u) is vector
    xb = tops.blockwise_lastdim(x, block=block).reshape(-1, block)
    before = tq.launch_counts()["qinf_quantize_blocks"]
    for bits in range(1, 8):
        ck, sk = tops.qinf_quantize_lastdim(x, u, bits=bits, block=block)
        assert ck.shape == u.shape and sk.shape == u.shape[:-1] + (1,)
        cr, sr = tref.qinf_quantize_blocks_ref(xb, u.reshape(-1, block), bits)
        assert torch.equal(ck.reshape(-1, block), cr), f"codes, bits={bits}"
        assert torch.equal(sk.reshape(-1, 1), sr), f"scales, bits={bits}"
        if zero_from is not None:
            assert float(sk[..., -1, :].abs().max()) == 0.0
            assert int(ck[..., -1, :].abs().max()) == 0
    assert tq.launch_counts()["qinf_quantize_blocks"] == before + 7


@pytest.mark.cuda
def test_cuda_b1_binding_refuses_a_wrong_noise_or_layout():
    """The binding holds the noise to the leaf's blocked shape (or, for
    rows of one block, to the leaf's own shape) and the leaf to rows of
    unit stride; each fault raises the ValueError naming it and nothing
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = torch.zeros((8, 7840), device="cuda")
    before = tq.launch_counts()
    for bad in [(8, 30, 256), (8, 31, 128), (248, 256), (8, 32, 256), ()]:
        with pytest.raises(ValueError, match="noise shape"):
            tq.qinf_quantize_blocks(x, torch.zeros(bad, device="cuda"), 2)
    y = torch.zeros((4, 6, 256), device="cuda")[:, :3]   # axes do not collapse
    with pytest.raises(ValueError, match="rows of unit stride"):
        tq.qinf_quantize_blocks(y, torch.zeros((4, 3, 1, 256), device="cuda"),
                                2)
    with pytest.raises(ValueError, match="rows of unit stride"):
        tq.qinf_quantize_blocks(x.t(), torch.zeros((7840, 1, 8),
                                                   device="cuda"), 2)
    assert tq.launch_counts() == before
    c, s = tq.qinf_quantize_blocks(x[:, :256].contiguous(),
                                   torch.zeros((8, 256), device="cuda"), 2)
    assert c.shape == (8, 256) and s.shape == (8, 1)


# ---------------------------------------------------------------------------
# B1 with a level count per grid point (the sweep's stacked grid): P points
# stacked on the leaf's leading axis, point p at its own bits, one launch.
# ---------------------------------------------------------------------------

# (leaf shape with the point axis leading, block, the points' bits):
# bits 1-8 on a ragged tail, and the stacked grid's (P, 8, 7840) leaf (31
# blocks of 256 a row, the last 160 wide) at bits 2, 4, 8, 1
POINT_LEVEL_CASES = [((8, 4, 300), 128, (1, 2, 3, 4, 5, 6, 7, 8)),
                     ((4, 8, 7840), 256, (2, 4, 8, 1))]


def _levels(bits, device="cpu"):
    return torch.tensor([float(2 ** (b - 1)) for b in bits],
                        dtype=torch.float32, device=device)


def _point_leaf(shape, block, dtype, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    x[0, 1] = 0                      # a point's row of zeros
    u = torch.rand(tops.blockwise_shape(shape, block), generator=g,
                   device=device)
    return x, u


@pytest.mark.parametrize("case", range(len(POINT_LEVEL_CASES)))
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_point_levels_plain_equals_fixed_bits_per_point(case, dtype):
    """The per-point-level plain twin on the stacked leaf: point p's codes
    and scales are those of the fixed-bits twin at its bits, bit for bit,
    and B2 decodes them as it decodes a point's own."""
    shape, block, bits = POINT_LEVEL_CASES[case]
    x, u = _point_leaf(shape, block, _TDT[dtype])
    codes, scales = tops.qinf_quantize_lastdim(x, u, block=block,
                                               levels=_levels(bits))
    out = tops.qinf_dequantize_lastdim(codes, scales, shape, torch.float32,
                                       block=block)
    for p, b in enumerate(bits):
        cp, sp = tops.qinf_quantize_lastdim(x[p], u[p], bits=b, block=block)
        assert torch.equal(codes[p], cp) and torch.equal(scales[p], sp), b
        assert torch.equal(out[p], tops.qinf_dequantize_lastdim(
            cp, sp, shape[1:], torch.float32, block=block))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_point_levels_plain_equals_reference_traced_bits(dtype):
    """The plain twin against the reference's traced-bits quantizer
    (``repro.sweep._TracedBitsQInf._quantize``, the level count a traced
    operand) on the same x, u and level count, point by point."""
    from repro import sweep as jsweep
    rng = np.random.default_rng(3)
    bits = (1, 2, 3, 4, 5, 6, 7, 8)
    x = jnp.asarray(rng.normal(size=(8, 6, 256)) * 3).astype(_JDT[dtype])
    u = jnp.asarray(rng.random((8, 6, 256)), jnp.float32)
    tx, tu = _to_torch(x, _TDT[dtype]), torch.from_numpy(np.array(u))
    codes, scales = tq.qinf_quantize_blocks(
        tx.reshape(-1, 256), tu.reshape(-1, 256), 2, levels=_levels(bits))
    for p, b in enumerate(bits):
        q = jsweep._TracedBitsQInf(jnp.float32(2 ** (b - 1)), 256, False)
        jc, js = q._quantize(x[p].astype(jnp.float32), u[p])
        assert np.array_equal(codes[p * 6:(p + 1) * 6].numpy(),
                              np.asarray(jc)), b
        assert np.array_equal(scales[p * 6:(p + 1) * 6].numpy(),
                              np.asarray(js)), b


def test_point_levels_wrapper_names_each_fault():
    x, u = torch.zeros((8, 256)), torch.zeros((8, 256))
    with pytest.raises(ValueError, match="powers of two"):
        tq.qinf_quantize_blocks(x, u, 2, levels=torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError, match="powers of two"):
        tq.qinf_quantize_blocks(x, u, 2, levels=torch.tensor([256.0, 1.0]))
    with pytest.raises(ValueError, match="dividing the 8 rows"):
        tq.qinf_quantize_blocks(x, u, 2, levels=_levels((2, 4, 8)))
    with pytest.raises(TypeError, match="f32"):
        tq.qinf_quantize_blocks(x, u, 2, levels=_levels((2, 4)).double())


def test_point_levels_launch_counts_as_b1(monkeypatch):
    """The per-point entry of the binding is B1: its launches count under
    ``qinf_quantize_blocks``."""
    monkeypatch.setattr(tq, "_LAUNCHERS", {
        "qinf_quantize_blocks_levels": lambda *a: ("codes", "scales")})
    tq.reset_launch_counts()
    assert tq._launch("qinf_quantize_blocks_levels", 1, 2, 3) == \
        ("codes", "scales")
    assert tq.launch_counts()["qinf_quantize_blocks"] == 1
    tq.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(POINT_LEVEL_CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_point_levels_match_fixed_bits_and_plain(case, dtype):
    """B1's per-point launch on the card: one launch, point by point
    bit-equal to a fixed-bits launch at the point's bits and to the plain
    twin; a bad level operand is refused by the binding, naming it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    shape, block, bits = POINT_LEVEL_CASES[case]
    x, u = _point_leaf(shape, block, dtype, device="cuda")
    lv = _levels(bits, "cuda")
    before = tq.launch_counts()["qinf_quantize_blocks"]
    codes, scales = tops.qinf_quantize_lastdim(x, u, block=block, levels=lv)
    assert tq.launch_counts()["qinf_quantize_blocks"] == before + 1
    pc, ps = tops.qinf_quantize_lastdim(x.cpu(), u.cpu(), block=block,
                                        levels=lv.cpu())
    assert torch.equal(codes.cpu(), pc) and torch.equal(scales.cpu(), ps)
    for p, b in enumerate(bits):
        cp, sp = tops.qinf_quantize_lastdim(x[p], u[p], bits=b, block=block)
        assert torch.equal(codes[p], cp) and torch.equal(scales[p], sp)
    with pytest.raises(ValueError, match="power of two"):
        tops.qinf_quantize_lastdim(x, u, block=block,
                                   levels=lv + 1)
    with pytest.raises(ValueError, match="dividing"):
        tops.qinf_quantize_lastdim(x, u, block=block,
                                   levels=_levels((2, 4, 8), "cuda"))
    with pytest.raises(TypeError, match="f32"):
        tops.qinf_quantize_lastdim(x, u, block=block, levels=lv.double())
