"""mixtral-8x22b: 56L d=6144 48H (GQA kv=8) d_ff=16384 MoE 8e top-2, vocab
32768 (≈ 141 B parameters; full attention, as the HF config gives it).

[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, experts_per_token=2,
        fsdp=True, microbatches=16,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=256),
    )


def reduced() -> ModelConfig:
    # capacity_factor = n_experts: C = T·k, no copy ever drops
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
        n_experts=4, experts_per_token=2, fsdp=False, microbatches=1, capacity_factor=float(4),
        adapter=config().adapter.replace(rank_cap=16, layers="last2"),
    )
