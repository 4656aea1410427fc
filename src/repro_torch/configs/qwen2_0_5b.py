"""qwen2-0.5b: 24L d=896 14H (GQA kv=2) d_ff=4864, QKV bias.

[arXiv:2407.10671; hf:Qwen/Qwen2-0.5B]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151936, qkv_bias=True,
        rope_theta=1e6,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=160),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        adapter=config().adapter.replace(rank_cap=16, layers="last2"),
    )
