"""Architecture registry: ``get(arch_id)`` -> ModelConfig.

The port's copy of ``repro.configs``: the ten architectures as data, each
with its citation (:mod:`repro_torch.configs.shapes` holds the four input
shapes).
"""
from repro_torch.configs import shapes  # noqa: F401
from repro_torch.models.transformer import ModelConfig

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

_OTHER = {
    # 100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; gated
    # cross-attention image layers every 5th layer.  The ViT/SigLIP vision
    # encoder + projector is a stub: batches carry pre-projected patch
    # embeddings (B, n_vision_tokens, d_model).
    # [hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment]
    "llama-3.2-vision-90b": dict(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256, rope_theta=500000.0,
        cross_attn_every=5, n_vision_tokens=1601,
        citation="hf:meta-llama/Llama-3.2-11B-Vision (90B config per "
                 "assignment)"),
    # 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; 8 experts
    # top-2, sliding-window attention 4096.  [arXiv:2401.04088]
    "mixtral-8x7b": dict(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000, rope_theta=1e6,
        n_experts=8, top_k=2, sliding_window=4096,
        citation="arXiv:2401.04088"),
    # 32L enc + 32L dec, d_model=1280 20H (kv=20) d_ff=5120 vocab=51866;
    # LayerNorm + GELU + learned decoder positions (no RoPE); the conv
    # frontend is a stub: batches carry post-conv frame embeddings.
    # [arXiv:2212.04356]
    "whisper-large-v3": dict(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, head_dim=64, d_ff=5120, vocab=51866,
        norm="layernorm", act="gelu",
        max_source_positions=1500, max_target_positions=448,
        citation="arXiv:2212.04356"),
    # 28L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=102400;
    # fine-grained MoE: 2 shared + 64 routed top-6.  As listed every layer
    # is MoE on the capacity path, as the reference; the published layout
    # (a first dense FF layer of width 10944, softmax gates not
    # renormalised, the sequence-wise balance loss) is first_k_dense=1,
    # dense_d_ff=10944, moe_dropless=True, with n_experts_held /
    # expert_offset for one chip's share of the 64, and the trainer's
    # aux_weight at the published 0.001.
    # [arXiv:2401.06066]
    "deepseek-moe-16b": dict(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=102400, rope_theta=1e4,
        n_experts=64, top_k=6, n_shared_experts=2,
        citation="arXiv:2401.06066"),
    # 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU +
    # local attention (window 2048), pattern 1 attn : 2 recurrent.
    # [arXiv:2402.19427]
    "recurrentgemma-9b": dict(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256000, rope_theta=1e4,
        block_pattern=("rec", "rec", "attn"), lru_width=4096,
        conv_width=4, local_window=2048,
        citation="arXiv:2402.19427"),
    # "Finch": 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536;
    # data-dependent decay.  [arXiv:2404.05892]
    "rwkv6-7b": dict(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab=65536, rwkv_head_size=64,
        citation="arXiv:2404.05892"),
}

_REGISTRY = {**_DENSE, **_OTHER}

ARCH_IDS = ("llama-3.2-vision-90b", "yi-9b", "mixtral-8x7b",
            "whisper-large-v3", "deepseek-moe-16b", "qwen3-1.7b",
            "recurrentgemma-9b", "phi4-mini-3.8b", "qwen2-7b", "rwkv6-7b")


def get(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return ModelConfig(**_REGISTRY[arch_id])
