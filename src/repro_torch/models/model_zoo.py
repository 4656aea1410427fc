"""Public model API: :class:`Model` (port of ``repro/models/model_zoo.py``
for the dense family): init with QR-LoRA adapters, forward (logits, or
``(logits, aux)`` for the trainer), prefill and decode over the paged or
lock-step dense cache, the trainable mask and the parameter count."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapter_api
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm_lib

# Projections adaptable in the dense family: module key in groups → weights.
_ADAPTER_MODULES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate", "w_up", "w_down")}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ---- init ------------------------------------------------------------
    def init(self, gen: torch.Generator, with_adapters: bool = True) -> Dict:
        """Random params drawn from ``gen`` (on the generator's device, then
        moved to the model's), with QR-LoRA adapters computed from them."""
        params = tfm_lib.init_decoder_params(gen, self.cfg)
        params = _to(params, self.device)
        if with_adapters and self.cfg.adapter.mode != "none":
            params = self.attach_adapters(params)
        return params

    def _adapter_targets(self) -> Dict[str, Tuple[str, ...]]:
        """module → the weight names ``cfg.adapter.targets`` selects."""
        sel = {}
        for mod, weights in _ADAPTER_MODULES.items():
            picked = tuple(w for w in weights if w in self.cfg.adapter.targets)
            if picked:
                sel[mod] = picked
        return sel

    def attach_adapters(self, params: Dict) -> Dict:
        """Pivoted-QR factors of the current weights, installed under
        ``groups["adapters"]``."""
        groups = dict(params["groups"])
        adapters = {}
        for mod, weights in self._adapter_targets().items():
            stacked = {w: groups[mod][w] for w in weights}
            adapters[mod] = adapter_api.init_adapters(self.cfg, stacked)
        groups["adapters"] = adapters
        return {**params, "groups": groups}

    # ---- forward ---------------------------------------------------------
    # ``seg_ids`` (int32 (batch,)) selects a per-sequence adapter slot when
    # the params carry a packed multi-tenant λ table (see repro_torch.serving).
    def apply(self, params, tokens, seg_ids=None, train: bool = False):
        """Full-sequence forward → fp32 logits (B, S, V); with ``train=True``
        ``(logits, aux)`` as the reference's trainer takes them (``aux``, the
        MoE balance loss, is 0 for the dense family)."""
        logits = tfm_lib.decoder_apply(params, self.cfg, tokens, seg_ids=seg_ids)
        if not train:
            return logits
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def init_decode_state(self, batch: int, max_len: int, dtype=torch.bfloat16,
                          paged: bool = False, block_size: int = 16,
                          n_blocks: Optional[int] = None) -> Dict:
        return tfm_lib.init_decode_state(
            self.cfg, batch, max_len, dtype, paged=paged, block_size=block_size,
            n_blocks=n_blocks, device=self.device,
        )

    def lane_axes(self) -> Dict:
        """LaneState protocol: lane axes of the paged per-lane cache."""
        return tfm_lib.decode_state_lane_axes(self.cfg)

    def paged_prefill_view(self, cache, write_ids):
        return tfm_lib.paged_prefill_view(self.cfg, cache, write_ids)

    def commit_paged_prefill(self, cache, filled, lane, table_row, length):
        return tfm_lib.commit_paged_prefill(self.cfg, cache, filled, lane, table_row, length)

    def prefill(self, params, cache, tokens, seg_ids=None, length=None):
        return tfm_lib.decoder_prefill(
            params, self.cfg, cache, tokens, seg_ids=seg_ids, length=length
        )

    def decode_step(self, params, cache, token, seg_ids=None, attend_blocks=None):
        return tfm_lib.decoder_decode(
            params, self.cfg, cache, token, seg_ids=seg_ids, attend_blocks=attend_blocks
        )

    # ---- PEFT helpers ------------------------------------------------------
    def trainable_mask(self, params) -> Dict:
        return adapter_api.trainable_mask(params, self.cfg)

    def count_trainable(self, params) -> int:
        return adapter_api.count_trainable_params(params, self.cfg)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
