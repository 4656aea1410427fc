"""jamba-1.5-large (398 B): 72L d=8192 64H (GQA kv=8) d_ff=24576, Mamba and
attention interleaved 7:1 in groups of 8 (attention at index 4), MoE 16e
top-2 at every other layer, vocab 65536.  One group at these widths holds
≈ 43.6 B parameters (≈ 87 GB in bf16), more than one card.

[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        n_experts=16, experts_per_token=2, moe_every=2,
        hybrid_period=8, hybrid_attn_index=4,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        fsdp=True, microbatches=8,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=256),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
        n_experts=4, experts_per_token=2, hybrid_period=8, hybrid_attn_index=4,
        mamba_d_state=4, fsdp=False, microbatches=1, capacity_factor=float(4),
        adapter=config().adapter.replace(rank_cap=16, layers="all"),
    )
