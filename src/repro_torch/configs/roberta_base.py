"""RoBERTa-base-shaped encoder (125M) — the paper's own substrate.

12L d=768 12H d_ff=3072 vocab 50265, learned positions, classification head
(widths of FacebookAI/roberta-base, as the reference's config gives them).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config(n_classes: int = 2) -> ModelConfig:
    return ModelConfig(
        name="roberta-base", family="encoder",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=50265,
        is_encoder=True, n_classes=n_classes, max_position=512, causal=False,
        dtype="float32", logits_dtype="float32",
        adapter=AdapterConfig(mode="qr_lora", targets=("wq",), layers="last4",
                              tau=0.5, rank_cap=256),
    )


def reduced(n_classes: int = 2) -> ModelConfig:
    return config(n_classes).replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        max_position=64,
        adapter=config().adapter.replace(rank_cap=32, layers="last4"),
    )
