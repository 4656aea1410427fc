"""llama-3.2-vision-11b backbone: 40L d=4096 32H (GQA kv=8) d_ff=14336,
gated cross-attention against image patch embeddings every 5th layer.
The vision frontend is a stub, as in the reference: callers feed
precomputed patch embeddings (B, 1600, 1280) as ``image_embeds``.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        cross_attn_every=5, n_image_tokens=1600, d_image=1280,
        rope_theta=5e5, microbatches=4,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=256),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        cross_attn_every=5, n_image_tokens=16, d_image=32, microbatches=1,
        adapter=config().adapter.replace(rank_cap=16, layers="all"),
    )
