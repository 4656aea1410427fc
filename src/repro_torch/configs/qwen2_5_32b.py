"""qwen2.5-32b: 64L d=5120 40H (GQA kv=8) d_ff=27648, QKV bias.

[hf:Qwen/Qwen2.5-32B family; hf]  Gradient accumulation over 8
microbatches, as the reference sets it; its FSDP flag has no counterpart in
the port.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab_size=152064, qkv_bias=True,
        rope_theta=1e6, microbatches=8,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=256),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=256,
        microbatches=1,
        adapter=config().adapter.replace(rank_cap=16, layers="last2"),
    )
