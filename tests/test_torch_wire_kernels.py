"""The port's wire-path kernels (B3 quantize+pack, B4 unpack+dequant+mix)
against the JAX package: plain versions against ``repro.kernels.ref`` and
the Pallas kernels (interpret mode), given the same x, noise u and weights.

Packed bytes, scales and qself must agree bit for bit.  The mix is
accumulated in sender order with one rounding per product and per sum in
the port (kernel and plain version alike), while the reference contracts
the sender axis with a dot that XLA may fuse into FMAs; the test bounds
the difference by |mix_port - mix_ref| <= (S + 1) * eps_f32 * sum_s
|w[t, s] Q_s| (every one of the S products and S - 1 sums rounds once,
relative eps/2 each), plus one ulp of the output dtype when it is bf16 (the
f32 sums may round to neighbouring bf16 values).

The CUDA kernels themselves run only on the card, where the ``cuda``
tests hold them against the plain versions; a machine with a card but
without JAX runs just those:

    python -m pytest --noconftest -m cuda tests/test_torch_wire_kernels.py
"""
import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import quantize as qk
    from repro.kernels import ref as kref
except ImportError:        # no JAX: only the cuda tests can run
    jax = None

from chip_smoke import b3_vector_expected, b4_vector_expected
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16} if jax is not None else {}
_EPS = {"f32": 0.0, "bf16": float(torch.finfo(torch.bfloat16).eps)}


def _t(a) -> torch.Tensor:
    """A JAX/numpy array -> torch, exactly (bf16 through f32)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _ref_pack(bits):
    """repro.kernels.ref's B3, compiled (eager jnp dispatch is slow)."""
    return jax.jit(lambda x, u: kref.qinf_quantize_pack_blocks_ref(x, u,
                                                                    bits))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).numpy() if t.is_floating_point() \
        else t.numpy()


def _payloads(S, R, block, bits, seed):
    """S senders' (packed, scales) from the reference's plain B3."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(S, R, block)) * 3, jnp.float32)
    x = x.at[:, 1].set(0.0)                       # an all-zero block
    u = jnp.asarray(rng.random((S, R, block)), jnp.float32)
    ps, ss = zip(*[_ref_pack(bits)(x[s], u[s]) for s in range(S)])
    return jnp.stack(ps), jnp.stack(ss)


def assert_mix_close(got: torch.Tensor, want, q_abs_w: torch.Tensor, S: int,
                     out: str):
    """The bound of the module docstring; ``q_abs_w`` = sum_s |w Q_s|."""
    diff = (got.to(torch.float64) - _t(want).to(torch.float64)).abs()
    bound = ((S + 1) * float(torch.finfo(torch.float32).eps)
             + _EPS[out]) * q_abs_w.to(torch.float64)
    assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("rows", [8, 16, 64])
@pytest.mark.parametrize("block", [4, 8, 16, 20, 32, 64, 128, 256])
def test_quantize_pack_matches_reference(bits, rows, block):
    """Plain B3 against repro.kernels.ref and the Pallas kernel at every
    block width the trainers give it (``default_quant_block`` of the ten
    families: 4 to 256): packed bytes and scales bit-exact; the bytes
    decode to B1's codes."""
    rng = np.random.default_rng(bits * 1000 + rows + block)
    x = jnp.asarray(rng.normal(size=(rows, block)) * 3, jnp.float32)
    x = x.at[rows // 2].set(0.0)
    u = jnp.asarray(rng.random((rows, block)), jnp.float32)
    pr, sr = _ref_pack(bits)(x, u)
    pk, sk = qk.qinf_quantize_pack_blocks(x, u, bits=bits, block=block,
                                          interpret=True)
    pt, st = tq.qinf_quantize_pack_blocks(_t(x), _t(u), bits)
    assert pt.dtype == torch.uint8 and pt.shape == (
        rows, tq.packed_width(block, bits))
    for p_, s_ in ((pr, sr), (pk, sk)):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(p_))
        np.testing.assert_array_equal(st.numpy(), np.asarray(s_))
    ct, _ = tq.qinf_quantize_blocks(_t(x), _t(u), bits)
    np.testing.assert_array_equal(
        tref.unpack_codes_halves_ref(pt, bits).numpy(), ct.numpy())


# every bits x block x out at S = T = 3 (rows 8, 16 or 64 by bits), the
# other (S, T) corners at bits 2, block 256, and the shapes the card's
# vector variant takes beyond four senders and at narrow rows: the
# alternating schedule's T = 2, S = 6 at blocks 256 and 16, nine senders,
# the MoE routers' block 8 (W = 4 at 2 bits, W = 8 at 4 bits)
_MIX_CASES = (
    [(bits, block, 3, 3, out, (8, 16, 64)[bits % 3])
     for bits in range(1, 8) for block in (128, 256)
     for out in ("f32", "bf16")]
    + [(2, 256, S, T, out, 16) for S, T in ((1, 1), (3, 1), (1, 3))
       for out in ("f32", "bf16")]
    + [(bits, block, S, T, out, 16)
       for bits, block, S, T in ((2, 256, 6, 2), (2, 128, 9, 1),
                                 (2, 8, 3, 1), (2, 16, 6, 2), (4, 8, 5, 3))
       for out in ("f32", "bf16")])


@pytest.mark.parametrize("bits,block,S,T,out,R", _MIX_CASES)
def test_unpack_dequant_mix_matches_reference(bits, block, S, T, out, R):
    """Plain B4 against repro.kernels.ref (compiled) and the Pallas kernel:
    qself bit-exact, mix within the stated bound."""
    packed, scales = _payloads(S, R, block, bits, seed=bits * 10 + S + T)
    w = jnp.asarray(np.random.default_rng(T).normal(size=(T, S)),
                    jnp.float32)
    mr, qr = jax.jit(lambda p, s, w_: kref.qinf_unpack_dequant_mix_blocks_ref(
        p, s, w_, bits, _JDT[out]))(packed, scales, w)
    mk, qk_ = qk.qinf_unpack_dequant_mix_blocks(
        packed, scales, w, bits=bits, block=block, out_dtype=_JDT[out],
        interpret=True)
    mt, qt = tq.qinf_unpack_dequant_mix_blocks(
        _t(packed)[None], _t(scales)[None], _t(w)[None], bits, _TDT[out])
    mt, qt = mt[0], qt[0]                             # one node
    assert mt.shape == (T, R, block) and mt.dtype == _TDT[out]
    # each Q_s as the port computes it, for the bound
    q = torch.stack([tq.qinf_unpack_dequant_mix_blocks(
        _t(packed[None, s:s + 1]), _t(scales[None, s:s + 1]),
        torch.ones((1, 1, 1)), bits, _TDT[out])[1][0].float()
        for s in range(S)])
    q_abs_w = torch.einsum("ts,srb->trb", _t(w).abs(), q.abs())
    for m_, q_ in ((mr, qr), (mk, qk_)):
        np.testing.assert_array_equal(_np(qt), np.asarray(q_.astype(
            jnp.float64)))
        assert_mix_close(mt, m_, q_abs_w, S, out)


def test_node_stacked_mix_is_per_node():
    """B4 mixes node by node: node n's slice of one call over N nodes
    equals a call over node n alone with its own weights, bit for bit."""
    bits, block, S, T, N = 2, 256, 3, 2, 4
    packed, scales = zip(*[_payloads(S, 8, block, bits, seed=n)
                           for n in range(N)])
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N, T, S)).astype(np.float32))
    P = torch.stack([_t(p) for p in packed])
    Sc = torch.stack([_t(s) for s in scales])
    mix, qself = tq.qinf_unpack_dequant_mix_blocks(P, Sc, w, bits)
    assert mix.shape == (N, T, 8, block) and qself.shape == (N, 8, block)
    for n in range(N):
        m1, q1 = tq.qinf_unpack_dequant_mix_blocks(
            P[n:n + 1], Sc[n:n + 1], w[n:n + 1], bits)
        assert torch.equal(mix[n:n + 1], m1) and torch.equal(
            qself[n:n + 1], q1)


def test_ops_wrappers_take_any_row_count():
    """The fused ops need no row padding: any R goes straight through."""
    x = torch.randn(13, 128)
    u = torch.rand(13, 128)
    p, s = tops.qinf_quantize_pack(x, u, bits=2, block=128)
    assert p.shape == (13, 64) and s.shape == (13, 1)
    jp, js = _ref_pack(2)(jnp.asarray(x.numpy()), jnp.asarray(u.numpy()))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    mix, qself = tops.qinf_unpack_dequant_mix(
        p[None, None], s[None, None], torch.ones((1, 1, 1)), bits=2,
        block=128)
    assert torch.equal(mix[:, 0], qself)
    with pytest.raises(ValueError):
        tops.qinf_quantize_pack(x, u, bits=2, block=256)


def test_wire_wrappers_validate():
    x = torch.zeros((8, 256))
    with pytest.raises(ValueError):
        tq.qinf_quantize_pack_blocks(x, torch.zeros((8, 128)), 2)
    with pytest.raises(ValueError):
        tq.qinf_quantize_pack_blocks(torch.zeros((8, 255)),
                                     torch.zeros((8, 255)), 2)
    with pytest.raises(TypeError):
        tq.qinf_quantize_pack_blocks(x.double(), x, 2)
    with pytest.raises(ValueError):
        tq.qinf_unpack_dequant_mix_blocks(
            torch.zeros((2, 8, 128), dtype=torch.uint8), torch.zeros((2, 8, 1)),
            torch.zeros((1, 3)), 2)
    tq.reset_launch_counts()
    p, s = tq.qinf_quantize_pack_blocks(x, torch.zeros((8, 256)), 2)
    tq.qinf_unpack_dequant_mix_blocks(p[None, None], s[None, None],
                                      torch.ones((1, 1, 1)), 2)
    assert tq.launch_counts()["qinf_quantize_pack_blocks"] == 0
    assert tq.launch_counts()["qinf_unpack_dequant_mix_blocks"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("block", [128, 256])
def test_cuda_wire_kernels_match_plain(bits, block):
    """B3/B4 on the card against their plain versions on the same inputs:
    packed bytes, scales, qself and mix exactly equal (both accumulate in
    sender order, one rounding per operation), node-stacked, S = 3,
    T = 1 and 3, f32, bf16 and f64 out, a ragged row count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(bits)
    N, S, R = 2, 3, 8 * 31 + 5
    x = torch.randn((N * S * R, block), generator=g, device="cuda") * 3
    x[7] = 0
    u = torch.rand(x.shape, generator=g, device="cuda")
    before = tq.launch_counts()
    pk, sk = tq.qinf_quantize_pack_blocks(x, u, bits)
    pr, sr = tref.qinf_quantize_pack_blocks_ref(x, u, bits)
    assert torch.equal(pk, pr) and torch.equal(sk, sr)
    P = pk.reshape(N, S, R, -1)
    Sc = sk.reshape(N, S, R, 1)
    for T in (1, 3):
        w = torch.randn((N, T, S), generator=g, device="cuda")
        for out in (torch.float32, torch.bfloat16, torch.float64):
            mk, qk_ = tq.qinf_unpack_dequant_mix_blocks(P, Sc, w, bits, out)
            mr, qr = tref.qinf_unpack_dequant_mix_blocks_ref(P, Sc, w, bits,
                                                             out)
            assert torch.equal(qk_, qr) and torch.equal(mk, mr)
    after = tq.launch_counts()
    assert after["qinf_quantize_pack_blocks"] == \
        before["qinf_quantize_pack_blocks"] + 1
    assert after["qinf_unpack_dequant_mix_blocks"] == \
        before["qinf_unpack_dequant_mix_blocks"] + 6


def _check_b3_on_card(x, u, bits, vector):
    """B3 on the card against its plain version on the same x and u: bytes
    and scales equal, one launch, the variant the rule names."""
    assert tq.uses_vector_variant("qinf_quantize_pack_blocks", x, u,
                                  bits) is vector
    before = tq.launch_counts()["qinf_quantize_pack_blocks"]
    pk, sk = tq.qinf_quantize_pack_blocks(x, u, bits)
    assert tq.launch_counts()["qinf_quantize_pack_blocks"] == before + 1
    pr, sr = tref.qinf_quantize_pack_blocks_ref(x, u, bits)
    assert torch.equal(pk, pr) and torch.equal(sk, sr)
    return pk, sk


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("block", [4, 8, 16, 20, 32, 64, 128, 256, 512,
                                   1024, 2048])
def test_cuda_b3_variants_match_plain(bits, block):
    """B3 on the card at every block width the trainers use and the
    vector variant's widest (1024) and one past it (2048, the row
    variant): 8 x 31 + 5 rows (at blocks 8 and 64 the last warp holds
    fewer rows than it can), an all-zero row (scale 0, every code 0, so
    every encoded value is the offset 2^(b-1))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(bits * 10_000 + block)
    R = 8 * 31 + 5
    x = torch.randn((R, block), generator=g, device="cuda") * 3
    x[5] = 0
    u = torch.rand((R, block), generator=g, device="cuda")
    pk, sk = _check_b3_on_card(x, u, bits, b3_vector_expected(block, bits))
    L = 2 ** (bits - 1)
    zero_byte = L | L << 4 if bits <= 3 else L
    assert float(sk[5]) == 0.0 and bool((pk[5] == zero_byte).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block,x_off,u_off", [
    (2, 256, 1, 0), (2, 256, 0, 1), (2, 8, 1, 1), (4, 64, 2, 0),
    (4, 128, 0, 3), (7, 1024, 1, 1)])
def test_cuda_b3_off_alignment_takes_row_variant(bits, block, x_off, u_off):
    """x or u a contiguous view ``x_off`` / ``u_off`` f32 into its buffer,
    off the 16-byte alignment, at widths that otherwise take the vector
    variant: the row variant, bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(block + x_off + u_off)
    R = 8 * 31 + 5
    n = R * block
    x = (torch.randn(n + x_off, generator=g, device="cuda") * 3)[x_off:]
    u = torch.rand(n + u_off, generator=g, device="cuda")[u_off:]
    x, u = x.view(R, block), u.view(R, block)
    assert b3_vector_expected(block, bits)
    _check_b3_on_card(x, u, bits, vector=False)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that says it lies on another device than the CPU, the
    card or ``meta``."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t):
    return torch.Tensor._make_subclass(_Elsewhere, t)


def test_b4_wrapper_validates_before_any_launch():
    """Shapes, S and T >= 1, bits, dtypes and devices are checked on every
    path (a device other than the card, the CPU and ``meta`` raises; a
    ``meta`` call takes the card's route dry); the CPU and ``meta`` paths
    launch nothing."""
    P = torch.zeros((2, 3, 5, 64), dtype=torch.uint8)
    Sc = torch.ones((2, 3, 5, 1))
    with pytest.raises(ValueError):                     # T = 0
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, torch.ones((2, 0, 3)), 2)
    with pytest.raises(ValueError):                     # S = 0
        tq.qinf_unpack_dequant_mix_blocks(P[:, :0], Sc[:, :0],
                                          torch.ones((2, 1, 0)), 2)
    with pytest.raises(ValueError):                     # scales shape
        tq.qinf_unpack_dequant_mix_blocks(P, Sc[..., 0], torch.ones((2, 1, 3)),
                                          2)
    with pytest.raises(ValueError):                     # bits
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, torch.ones((2, 1, 3)), 8)
    with pytest.raises(TypeError):                      # weights dtype
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, torch.ones((2, 1, 3),
                                                            dtype=torch.int32),
                                          2)
    with pytest.raises(TypeError):                      # output dtype
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, torch.ones((2, 1, 3)), 2,
                                          torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qinf_unpack_dequant_mix_blocks(
            _elsewhere(P), _elsewhere(Sc), _elsewhere(torch.ones((2, 1, 3))),
            2)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qinf_quantize_pack_blocks(_elsewhere(torch.zeros((4, 8))),
                                     _elsewhere(torch.zeros((4, 8))), 2)
    tq.reset_launch_counts()
    # a meta tensor takes the card's route dry: outputs on meta, no launch
    dry = tq.qinf_unpack_dequant_mix_blocks(
        P.to("meta"), Sc.to("meta"), torch.ones((2, 1, 3), device="meta"), 2)
    assert [t.shape for t in dry] == [(2, 1, 5, 128), (2, 5, 128)]
    assert all(t.is_meta for t in dry)
    with pytest.raises(ValueError):                     # bits, on meta too
        tq.qinf_unpack_dequant_mix_blocks(
            P.to("meta"), Sc.to("meta"), torch.ones((2, 1, 3), device="meta"),
            8)
    mix, qself = tq.qinf_unpack_dequant_mix_blocks(P, Sc,
                                                   torch.ones((2, 1, 3)), 2)
    assert mix.shape == (2, 1, 5, 128) and qself.shape == (2, 5, 128)
    assert sum(tq.launch_counts().values()) == 0


def _cuda_payloads(N, S, R, block, bits, g, offset_bytes=0):
    """(packed (N, S, R, W), scales (N, S, R, 1)) from B3 on the card, the
    payload optionally a contiguous view ``offset_bytes`` into a buffer."""
    x = torch.randn((N * S * R, block), generator=g, device="cuda") * 3
    x[3] = 0
    u = torch.rand(x.shape, generator=g, device="cuda")
    pk, sk = tq.qinf_quantize_pack_blocks(x, u, bits)
    buf = torch.empty(pk.numel() + offset_bytes, dtype=torch.uint8,
                      device="cuda")
    P = buf[offset_bytes:].view(N, S, R, -1)
    P.copy_(pk.view(N, S, R, -1))
    return P, sk.reshape(N, S, R, 1)


def _cuda_mix_cases(P, Sc, bits, g, offset_bytes=0, rounds=(1, 3)):
    """B4 on the card against its plain version at each T of ``rounds``,
    f32, bf16 and f64 out: qself and mix exactly equal, one launch each,
    each on the variant :func:`chip_smoke.b4_vector_expected` names for
    the payload's width, the output dtype and the payload's offset in
    bytes from an aligned buffer.  Returns {out dtype: vector variant}."""
    N, S, _, W = P.shape
    vector = {}
    for T in rounds:
        w = torch.randn((N, T, S), generator=g, device="cuda")
        for out in (torch.float32, torch.bfloat16, torch.float64):
            before = tq.launch_counts()["qinf_unpack_dequant_mix_blocks"]
            mk, qk_ = tq.qinf_unpack_dequant_mix_blocks(P, Sc, w, bits, out)
            vector[out] = b4_vector_expected(W, out, offset_bytes)
            assert tq.uses_vector_variant(
                "qinf_unpack_dequant_mix_blocks", P, mk, qk_) is vector[out]
            mr, qr = tref.qinf_unpack_dequant_mix_blocks_ref(P, Sc, w, bits,
                                                             out)
            assert torch.equal(qk_, qr) and torch.equal(mk, mr), (T, out)
            assert tq.launch_counts()["qinf_unpack_dequant_mix_blocks"] == \
                before + 1
    return vector


# (bits, block, S, rounds, payload offset in bytes): the trainers' widths
# at S = 1, 3, 4 (4: exponential-8's self + 3 hops); S = 5, 6 and 9, past
# four senders (6 at the alternating schedule's T = 2); the MoE routers'
# blocks 8 and 16; S = 17 past the widest sender chunk (8) and T = 9 past
# the widest round chunk (2) of csrc/qinf_wire.cu's MixChunk; payload rows
# of 20 and 24 bytes (blocks 40 at 2 bits and 24 at 4 bits) and a payload
# 8 bytes into its buffer, not whole 16-byte chunks
_B4_VECTOR_CASES = (
    [(bits, block, S, (1, 3), 0) for bits in (2, 4) for block in (128, 256)
     for S in (1, 3, 4)]
    + [(2, 256, 5, (1, 3), 0), (2, 128, 9, (1, 3), 0), (2, 256, 6, (2,), 0),
       (2, 8, 3, (1, 3), 0), (2, 16, 6, (2,), 0), (4, 8, 5, (1, 3), 0),
       (2, 16, 3, (1,), 0), (2, 128, 17, (1, 3), 0), (2, 64, 3, (9,), 0),
       (4, 16, 17, (9,), 0), (2, 40, 3, (1, 3), 0), (4, 24, 3, (1, 3), 0),
       (2, 256, 3, (1, 3), 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block,S,rounds,offset_bytes", _B4_VECTOR_CASES)
def test_cuda_b4_vector_variant_matches_plain(bits, block, S, rounds,
                                              offset_bytes):
    """B4's vector variant (nibble packing at 2 bits, bytes at 4) at the
    trainers' widths and the routers' narrow rows, any S and T, 3 nodes of
    37 rows (the last thread block is not full): f32 out takes it at every
    case (bf16 at W = 4 or 20 does not: eight codes a store need W % 8 ==
    0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(bits * 100 + block + S)
    P, Sc = _cuda_payloads(3, S, 37, block, bits, g, offset_bytes)
    assert _cuda_mix_cases(P, Sc, bits, g, offset_bytes,
                           rounds)[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block,S,offset_bytes", [
    (2, 20, 3, 0), (2, 4, 3, 0), (2, 10, 6, 0), (4, 6, 3, 0),
    (2, 256, 3, 1), (4, 128, 4, 3), (2, 256, 6, 2), (2, 8, 3, 4),
    (4, 128, 4, 4)])
def test_cuda_b4_row_variant_matches_plain(bits, block, S, offset_bytes):
    """B4's row variant: payload rows no 16-byte store serves (block 20 at
    2 bits, W = 10; nibble-packed block 4, W = 2; W = 6 at 4 bits: f32 and
    bf16; W = 5: every output dtype) and payloads a contiguous view off the
    G-byte alignment (1 and 3 bytes: every dtype; 2: f32 and bf16; 4:
    bf16), S up to 6; each case takes the row variant for at least one
    output dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(block + S + offset_bytes)
    P, Sc = _cuda_payloads(2, S, 37, block, bits, g, offset_bytes)
    assert not all(_cuda_mix_cases(P, Sc, bits, g, offset_bytes).values())


@pytest.mark.cuda
def test_cuda_b3_b4_binding_names_each_fault():
    """On the card the binding alone checks B3's and B4's inputs: each
    fault raises the error that names it, and nothing launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = torch.zeros((8, 256), device="cuda")
    P = torch.zeros((2, 3, 5, 64), dtype=torch.uint8, device="cuda")
    Sc = torch.ones((2, 3, 5, 1), device="cuda")
    w = torch.ones((2, 1, 3), device="cuda")
    before = tq.launch_counts()
    with pytest.raises(ValueError, match="even block"):
        tq.qinf_quantize_pack_blocks(x[:, :255].contiguous(),
                                     x[:, :255].contiguous(), 2)
    with pytest.raises(TypeError, match="f32 x and u"):
        tq.qinf_quantize_pack_blocks(x.double(), x, 2)
    with pytest.raises(ValueError, match="contiguous on one CUDA device"):
        tq.qinf_quantize_pack_blocks(x, x.cpu(), 2)
    with pytest.raises(ValueError, match="shapes disagree"):
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, w[:, :0], 2)
    with pytest.raises(ValueError, match="bits must be in 1..7"):
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, w, 8)
    with pytest.raises(TypeError, match="uint8 payloads"):
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, w.int(), 2)
    with pytest.raises(TypeError, match="uint8 payloads"):
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2, torch.float16)
    with pytest.raises(ValueError, match="contiguous on one CUDA device"):
        tq.qinf_unpack_dequant_mix_blocks(P, Sc, w.cpu(), 2)
    assert tq.launch_counts() == before
