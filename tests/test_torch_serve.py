"""Serving (``repro_torch.launch.serve``) against the JAX package's
``repro.launch.serve``.

* ``generate`` -- prefill, then greedy decode -- on the reference's weights
  and prompts (reduced configurations, 2 layers, d_model 128, f32): the
  generated tokens equal the reference's ``generate``, and the logits each
  token was taken from agree, within ``MODEL_TOL`` (f32) of their largest
  entry, with the reference's teacher-forced forward over the generated
  sequence at the same positions.  MoE runs at ``capacity_factor =
  n_experts``, where a token routes alike in a pass of one token and of
  the whole sequence.
* The CLI at ``--layers 1 --d-model 128 --device cpu`` (2 layers for the
  vlm, whose cross-attention layer is every 2nd) for every architecture,
  and its refusal to run without a card unless asked for the CPU.
* On a card (``cuda`` marker): ``generate`` on the card equals ``generate``
  on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import serve as jserve
    from repro.models import transformer as JTR
except ImportError:        # no JAX: only the cuda test can run
    jax = None

from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TTR

TOL = 1e-5                     # MODEL_TOL["float32"]
B, PROMPT, GEN = 2, 6, 6
ARCHS = ("qwen3-1.7b", "mixtral-8x7b", "deepseek-moe-16b", "rwkv6-7b",
         "recurrentgemma-9b", "llama-3.2-vision-90b", "whisper-large-v3")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(configs, arch):
    """The reduced configuration (d_model 128); MoE at capacity_factor =
    n_experts."""
    cfg = configs.get(arch).reduced(d_model=128)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _extras(cfg, rng):
    if cfg.family == "vlm":
        return {"vision": rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.normal(
            size=(B, 8, cfg.d_model)).astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    jcfg, tcfg = _cfg(jconfigs, arch), _cfg(tconfigs, arch)
    rng = np.random.default_rng(7)
    p = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)
                   ).astype(np.float32),
        JTR.init_params(jcfg, jax.random.key(0)))
    prompt = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    extras = _extras(jcfg, rng)

    want = np.asarray(jserve.generate(jcfg, p, jnp.asarray(prompt), GEN,
                                      {k: jnp.asarray(v)
                                       for k, v in extras.items()}))
    got, logits = tserve.generate(
        tcfg, convert.tree_to_torch(p, device="cpu"),
        torch.from_numpy(prompt.astype(np.int64)), GEN,
        {k: torch.from_numpy(v) for k, v in extras.items()},
        return_logits=True)
    assert got.shape == (B, PROMPT + GEN) and logits.shape == (
        GEN, B, tcfg.padded_vocab)
    np.testing.assert_array_equal(got.numpy(), want)
    full = np.asarray(JTR.forward(jcfg, p, {"tokens": want, **extras})[0])
    for i in range(GEN):
        ref = full[:, PROMPT - 1 + i]
        err = np.abs(logits[i].numpy() - ref).max() / np.abs(ref).max()
        assert err <= TOL, (i, err)
        # the token is the argmax of the logits it was taken from
        np.testing.assert_array_equal(logits[i].argmax(-1).numpy(),
                                      want[:, PROMPT + i])


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cli_generates_on_the_cpu(arch, capsys):
    layers = "2" if tconfigs.get(arch).family == "vlm" else "1"
    out = tserve.main(["--arch", arch, "--layers", layers, "--d-model",
                       "128", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "4"])
    cfg = tconfigs.get(arch).reduced(n_layers=int(layers), d_model=128)
    assert out.shape == (2, 9) and out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab
    assert f"arch={arch} generated (2, 9) on cpu" in capsys.readouterr().out


def test_cli_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--layers", "1", "--d-model", "64"])
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "not-an-arch", "--device", "cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_generate_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(tconfigs, arch)
    g = torch.Generator().manual_seed(0)
    params = TTR.init_params(cfg, g, "cpu")
    prompt = torch.randint(0, cfg.vocab, (B, PROMPT), generator=g)
    extras = {k: torch.from_numpy(v) for k, v in
              _extras(cfg, np.random.default_rng(0)).items()}
    want, wl = tserve.generate(cfg, params, prompt, GEN, extras,
                               return_logits=True)
    to = lambda t: t.to("cuda")                               # noqa: E731
    got, gl = tserve.generate(cfg, tree.tree_map(to, params), to(prompt),
                              GEN, {k: to(v) for k, v in extras.items()},
                              return_logits=True)
    torch.testing.assert_close(gl.cpu(), wl, rtol=0, atol=1e-3 * float(
        wl.abs().max()))
    assert torch.equal(got.cpu(), want)
