"""xlstm-125m: 12L d=768 4H, alternating mLSTM/sLSTM blocks, d_ff=0 (the
expansion lives inside the blocks), vocab 50304.

[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        xlstm_pattern="ms",
        adapter=AdapterConfig(mode="qr_lora", targets=("x_qkv",), layers="last4",
                              tau=0.5, rank_cap=160),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
        adapter=config().adapter.replace(rank_cap=8, layers="all"),
    )
