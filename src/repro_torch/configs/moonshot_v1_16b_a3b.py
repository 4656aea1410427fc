"""moonshot-v1-16b-a3b (kimi/moonlight): 48L d=2048 16H (MHA kv=16) MoE 64e
top-6, d_ff 1408 per expert, vocab 163840 (≈ 28 B parameters, ≈ 3.5 B
active a token).

[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        n_experts=64, experts_per_token=6,
        fsdp=True, microbatches=8,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=160),
    )


def reduced() -> ModelConfig:
    # capacity_factor = n_experts: C = T·k, no copy ever drops
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=256,
        n_experts=8, experts_per_token=2, fsdp=False, microbatches=1, capacity_factor=float(8),
        adapter=config().adapter.replace(rank_cap=16, layers="last2"),
    )
