"""Architecture configs of the port: ``get_config(name)`` /
``get_reduced(name)`` (``-`` and ``_`` alike in names)."""
from repro_torch.configs import roberta_base, smollm_135m
from repro_torch.configs.base import AdapterConfig, ModelConfig

ARCHS = {"smollm-135m": smollm_135m, "roberta-base": roberta_base}


def _module(name: str):
    try:
        return ARCHS[name.replace("_", "-")]
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
