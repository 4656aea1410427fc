"""qwen3-14b: 40L d=5120 40H (GQA kv=8) d_ff=17408, QK-norm.

[hf:Qwen/Qwen3-8B; hf]  Gradient accumulation over 4 microbatches, as the
reference sets it; its FSDP flag has no counterpart in the port.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab_size=151936, qk_norm=True,
        rope_theta=1e6, microbatches=4,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=256),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        microbatches=1,
        adapter=config().adapter.replace(rank_cap=16, layers="last2"),
    )
