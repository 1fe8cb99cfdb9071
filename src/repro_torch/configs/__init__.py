"""Architecture registry: ``get(arch_id)`` -> ModelConfig.

The port's copy of ``repro.configs``.  The dense-family configurations
are pure data and live here; the other families' configurations arrive
with the slice that ports their model code, and ``get`` names it.
"""
from repro_torch.models.transformer import LATER_FAMILIES, ModelConfig

_DENSE = {
    # 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936; qk_norm
    # (RMSNorm on q/k heads), head_dim=128.  [hf:Qwen/Qwen3-8B family card]
    "qwen3-1.7b": dict(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab=151936, rope_theta=1e6, qk_norm=True,
        citation="hf:Qwen/Qwen3-8B"),
    # 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
    # [arXiv:2403.04652]
    "yi-9b": dict(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab=64000, rope_theta=5e6,
        citation="arXiv:2403.04652"),
    # 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
    # [arXiv:2412.08905]
    "phi4-mini-3.8b": dict(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=200064, rope_theta=1e4,
        citation="arXiv:2412.08905"),
    # 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; QKV biases.
    # [arXiv:2407.10671]
    "qwen2-7b": dict(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152064, rope_theta=1e6, qkv_bias=True,
        citation="arXiv:2407.10671"),
}

# the reference's other architectures, by family
_LATER = {"llama-3.2-vision-90b": "vlm", "mixtral-8x7b": "moe",
          "whisper-large-v3": "encdec", "deepseek-moe-16b": "moe",
          "recurrentgemma-9b": "hybrid", "rwkv6-7b": "ssm"}

ARCH_IDS = ("llama-3.2-vision-90b", "yi-9b", "mixtral-8x7b",
            "whisper-large-v3", "deepseek-moe-16b", "qwen3-1.7b",
            "recurrentgemma-9b", "phi4-mini-3.8b", "qwen2-7b", "rwkv6-7b")


def get(arch_id: str) -> ModelConfig:
    if arch_id in _LATER:
        fam = _LATER[arch_id]
        raise NotImplementedError(
            f"arch {arch_id!r} ({fam} family) is not ported yet; it arrives "
            f"with {LATER_FAMILIES[fam]}")
    if arch_id not in _DENSE:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return ModelConfig(**_DENSE[arch_id])
