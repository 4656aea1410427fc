"""Architecture configs of the port: ``get_config(name)`` /
``get_reduced(name)`` (``-``, ``_`` and ``.`` alike in names, as the
reference's registry resolves them)."""
from repro_torch.configs import (
    llama_3_2_vision_11b,
    mixtral_8x22b,
    moonshot_v1_16b_a3b,
    musicgen_medium,
    qwen2_0_5b,
    qwen2_5_32b,
    qwen3_14b,
    roberta_base,
    smollm_135m,
)
from repro_torch.configs.base import AdapterConfig, ModelConfig

ARCHS = {
    "smollm-135m": smollm_135m,
    "qwen2-0.5b": qwen2_0_5b,
    "qwen3-14b": qwen3_14b,
    "qwen2.5-32b": qwen2_5_32b,
    "roberta-base": roberta_base,
    "musicgen-medium": musicgen_medium,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "mixtral-8x22b": mixtral_8x22b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
}


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


_BY_NORM = {_norm(name): mod for name, mod in ARCHS.items()}


def _module(name: str):
    try:
        return _BY_NORM[_norm(name)]
    except KeyError:
        raise NotImplementedError(
            f"arch {name!r}: the port has {sorted(ARCHS)} so far"
        ) from None


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return cfg.replace(**overrides) if overrides else cfg


def get_reduced(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).reduced()
    return cfg.replace(**overrides) if overrides else cfg
