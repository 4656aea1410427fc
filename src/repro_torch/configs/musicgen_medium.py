"""musicgen-medium backbone: 48L d=1536 24H (MHA) d_ff=6144 over EnCodec
codes (vocab 2048).  The EnCodec frontend is a stub, as in the reference:
callers feed precomputed frame embeddings (``embeds``) or code tokens.

[arXiv:2306.05284; hf:facebook/musicgen-medium]
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        adapter=AdapterConfig(mode="qr_lora", targets=("wq", "wv"), layers="last4",
                              tau=0.5, rank_cap=128),
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
        adapter=config().adapter.replace(rank_cap=8, layers="last2"),
    )
