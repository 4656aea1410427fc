"""smollm-135m (llama-arch): 30L d=576 9H (GQA kv=3) d_ff=1536.

[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab_size=49152,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=128),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_ff=96, vocab_size=256,
        adapter=config().adapter.replace(rank_cap=8, layers="last2"),
    )
