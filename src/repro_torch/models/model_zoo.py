"""Public model API: :class:`Model` (port of ``repro/models/model_zoo.py``
for the dense, audio, moe, vlm, hybrid and ssm decoders and the
RoBERTa-style encoder): init with adapters
(QR-LoRA, LoRA, SVD-LoRA), forward (decoder logits, or ``(logits, aux)``
for the trainer; encoder task outputs), prefill and decode over the paged,
per-lane dense or lock-step dense cache, the trainable mask and the
parameter count; the speculative verify step."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapter_api
from repro_torch.device import resolve_device
from repro_torch.models import encoder as enc_lib
from repro_torch.models import transformer as tfm_lib

# Projections adaptable per family: module key in groups → weight names.
_ADAPTER_MODULES = {
    "dense": {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate", "w_up", "w_down")},
    "audio": {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate", "w_up", "w_down")},
    "moe": {"attn": ("wq", "wk", "wv", "wo")},
    "hybrid": {"attn": ("wq", "wk", "wv", "wo"), "mamba": ("m_in", "m_out")},
    "ssm": {"mlstm": ("x_qkv", "x_up", "x_down"), "slstm": ("x_qkv", "x_up", "x_down")},
    "vlm": {"attn": ("wq", "wk", "wv", "wo"), "xattn": ("wq", "wk", "wv", "wo")},
    "encoder": {"attn": ("wq", "wk", "wv", "wo")},
}

# adapter-config target name → (module, weight) aliases
_TARGET_ALIAS = {
    "mamba_in": ("mamba", "m_in"),
    "mamba_out": ("mamba", "m_out"),
}

# The encoder's task head trains beside the adapters outside ft (the paper's
# GLUE setup).
_HEAD = ("cls_w", "cls_b", "pooler")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ---- init ------------------------------------------------------------
    def init(self, gen: torch.Generator, with_adapters: bool = True) -> Dict:
        """Random params drawn from ``gen`` (on the generator's device, then
        moved to the model's), with adapters computed from them (LoRA's A
        drawn from ``gen`` too)."""
        if self.cfg.is_encoder:
            params = enc_lib.init_encoder_params(gen, self.cfg)
        else:
            params = tfm_lib.init_decoder_params(gen, self.cfg)
        params = _to(params, self.device)
        if with_adapters and self.cfg.adapter.mode not in ("none", "ft"):
            params = self.attach_adapters(gen, params)
        return params

    def _adapter_targets(self) -> Dict[str, Tuple[str, ...]]:
        """module → the weight names ``cfg.adapter.targets`` selects (in
        the targets' order; ``mamba_in``/``mamba_out`` name the Mamba
        layers' ``m_in``/``m_out``)."""
        family = "encoder" if self.cfg.is_encoder else self.cfg.family
        modules = _ADAPTER_MODULES.get(family, {})
        sel = {}
        for t in self.cfg.adapter.targets:
            if t in _TARGET_ALIAS:
                mod, w = _TARGET_ALIAS[t]
                if mod in modules:
                    sel.setdefault(mod, []).append(w)
                continue
            for mod, weights in modules.items():
                if t in weights:
                    sel.setdefault(mod, []).append(t)
        return {m: tuple(ws) for m, ws in sel.items()}

    def attach_adapters(self, gen: Optional[torch.Generator], params: Dict) -> Dict:
        """Factors of the current weights (pivoted QR, LoRA drawn from
        ``gen``, or SVD) installed under ``groups["adapters"]``; on the
        svd_lora path with subtract-init the weights they came from are
        replaced by the subtracted ones.  A stack with more than one lead
        axis (the vlm self layers' (G, P-1)) is flattened first, so the layer
        selection ("last4") counts its layers in stack order, each stack on
        its own, and the factors take the lead axes back."""
        groups = dict(params["groups"])
        adapters = {}
        for mod, weights in self._adapter_targets().items():
            mod_params = dict(groups[mod])
            lead = {w: mod_params[w].shape[:-2] for w in weights}
            sub, new_w = adapter_api.init_adapters(
                gen, self.cfg,
                {w: mod_params[w].reshape(-1, *mod_params[w].shape[-2:]) for w in weights})
            for w in weights:
                mod_params[w] = new_w[w].reshape(*lead[w], *new_w[w].shape[1:])
                if w in sub:
                    adapters.setdefault(mod, {})[w] = {
                        k: t.reshape(*lead[w], *t.shape[1:]) for k, t in sub[w].items()}
            groups[mod] = mod_params
        groups["adapters"] = adapters
        return {**params, "groups": groups}

    def dryrun_params(self) -> Dict:
        """The params' exact shapes and dtypes as meta tensors, with no
        allocation at any width (the dry-run's stand-in for :meth:`init`).

        A meta-device walk of the init: the init draws every leaf on its
        generator's device, and :class:`_MetaGenerator` reads ``meta``
        there, so the init's own code runs and each draw is a shape with
        no storage (a real draw of jamba-1.5-large-398b would be ≈ 800 GB
        on the host).  ``torch._subclasses.FakeTensorMode`` would run the
        same code, but through a dispatch mode on every op and with fake
        CPU tensors still to turn into meta ones.  The adapters are
        :func:`adapter_api.dryrun_adapters`' shapes: no QR runs."""
        gen = _MetaGenerator()
        cfg = self.cfg
        if cfg.is_encoder:
            params = enc_lib.init_encoder_params(gen, cfg)
        else:
            params = tfm_lib.init_decoder_params(gen, cfg)
        if cfg.adapter.mode in ("none", "ft"):
            return params
        groups = dict(params["groups"])
        adapters = {}
        for mod, weights in self._adapter_targets().items():
            lead = {w: groups[mod][w].shape[:-2] for w in weights}
            sub = adapter_api.dryrun_adapters(
                cfg, {w: (math.prod(lead[w]), *groups[mod][w].shape[-2:]) for w in weights})
            adapters[mod] = {
                w: {k: t.reshape(*lead[w], *t.shape[1:]) for k, t in adp.items()}
                for w, adp in sub.items()}
        groups["adapters"] = adapters
        return {**params, "groups": groups}

    # ---- forward ---------------------------------------------------------
    # ``seg_ids`` (int32 (batch,)) selects a per-sequence adapter slot when
    # the params carry a packed multi-tenant λ table (see repro_torch.serving).
    def apply(self, params, tokens=None, seg_ids=None, train: bool = False, attn_mask=None,
              embeds=None, image_embeds=None):
        """Full-sequence forward.  Decoder: fp32 logits (B, S, V) of
        ``tokens``, or of ``embeds`` (B, S, d; the audio family's frames),
        with ``image_embeds`` (B, n_image_tokens, d_image) for vlm;
        encoder: the fp32 task output (B, n_classes), ``attn_mask`` (B, S)
        marking the keys to attend to.  With ``train=True`` ``(out, aux)`` as the
        reference's trainer takes them (``aux``: the moe layers' summed
        load-balancing loss, 0 for the other families); a decoder's train
        forward remats its layer groups when ``cfg.remat``."""
        if self.cfg.is_encoder:
            out = enc_lib.encoder_apply(params, self.cfg, tokens, attn_mask)
            aux = torch.zeros((), dtype=torch.float32, device=out.device)
        else:
            out, aux = tfm_lib.decoder_apply(params, self.cfg, tokens, seg_ids=seg_ids,
                                             embeds=embeds, image_embeds=image_embeds,
                                             train=train)
        return (out, aux) if train else out

    def init_decode_state(self, batch: int, max_len: int, dtype=torch.bfloat16,
                          per_lane: bool = False, paged: bool = False, block_size: int = 16,
                          n_blocks: Optional[int] = None) -> Dict:
        return tfm_lib.init_decode_state(
            self.cfg, batch, max_len, dtype, per_lane=per_lane, paged=paged,
            block_size=block_size, n_blocks=n_blocks, device=self.device,
        )

    def lane_axes(self, paged: bool = False) -> Dict:
        """LaneState protocol: lane axes of the per-lane cache (dense, or
        paged)."""
        return tfm_lib.decode_state_lane_axes(self.cfg, paged=paged)

    def paged_prefill_view(self, cache, write_ids, read_ids=None):
        return tfm_lib.paged_prefill_view(self.cfg, cache, write_ids, read_ids)

    def commit_paged_prefill(self, cache, filled, lane, table_row, length):
        return tfm_lib.commit_paged_prefill(self.cfg, cache, filled, lane, table_row, length)

    def prefill(self, params, cache, tokens=None, seg_ids=None, length=None, start=None,
                embeds=None, image_embeds=None):
        return tfm_lib.decoder_prefill(
            params, self.cfg, cache, tokens, seg_ids=seg_ids, length=length, start=start,
            embeds=embeds, image_embeds=image_embeds,
        )

    def decode_step(self, params, cache, token=None, seg_ids=None, attend_blocks=None,
                    embeds=None, image_embeds=None):
        return tfm_lib.decoder_decode(
            params, self.cfg, cache, token, seg_ids=seg_ids, attend_blocks=attend_blocks,
            embeds=embeds, image_embeds=image_embeds,
        )

    def verify_step(self, params, cache, tokens, seg_ids=None, n_valid=None,
                    attend_blocks=None):
        """Speculative verify: ``tokens`` (B, W) windows at each lane's own
        positions → (logits (B, W, V), cache with its offsets unchanged); see
        ``transformer.decoder_verify``."""
        return tfm_lib.decoder_verify(
            params, self.cfg, cache, tokens, seg_ids=seg_ids, n_valid=n_valid,
            attend_blocks=attend_blocks,
        )

    # ---- PEFT helpers ------------------------------------------------------
    def trainable_mask(self, params, extra_trainable=()) -> Dict:
        extra = tuple(extra_trainable)
        if self.cfg.is_encoder and self.cfg.adapter.mode != "ft":
            extra = extra + _HEAD
        return adapter_api.trainable_mask(params, self.cfg, extra)

    def count_trainable(self, params, include_head: bool = False) -> int:
        return adapter_api.count_trainable_params(
            params, self.cfg, _HEAD if include_head else ())


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: the init draws on
    its generator's device, so its draws are meta tensors (shapes only)."""

    @property
    def device(self):
        return torch.device("meta")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
