"""Architecture configs the port serves: ``get_config(name)`` /
``get_reduced(name)``."""
from repro_torch.configs import smollm_135m
from repro_torch.configs.base import AdapterConfig, ModelConfig

ARCHS = {"smollm-135m": smollm_135m}


def _module(name: str):
    try:
        return ARCHS[name.replace("_", "-")]
    except KeyError:
        raise NotImplementedError(
            f"arch {name!r}: the port serves {sorted(ARCHS)} so far"
        ) from None


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return cfg.replace(**overrides) if overrides else cfg


def get_reduced(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).reduced()
    return cfg.replace(**overrides) if overrides else cfg
