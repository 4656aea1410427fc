"""Decoder LM, dense, audio, moe, vlm, hybrid and ssm families (port of
``repro/models/transformer.py``).

The audio family (musicgen-medium) is the dense stack over EnCodec frame
embeddings: every forward takes ``embeds`` (B, S, d) in place of
``tokens``, cast to the model dtype, and its head scores the code
vocabulary.  Given code tokens instead, it embeds them as the dense family
does (the serving engine's path, as in the reference).

The moe family (moonshot-v1-16b-a3b, mixtral-8x22b) is the same stack with
``models/moe.py``'s routed experts in place of every layer's gated MLP
(``groups["moe"]``); each call routes its own B·S rows, and the layers'
load-balancing aux losses add up for the trainer.

The vlm family (llama-3.2-vision-11b) stacks its layers in groups of
``P = cross_attn_every``: P-1 self-attention layers, then one gated
cross-attention layer against the image rows, ``x + tanh(xa_gate)·out``
(the tanh in float32, cast to x's dtype), each followed by its gated MLP.
Its leaves carry two lead axes where the reference's scan carries them:
``ln1``/``ln2`` (G, P, d), ``attn`` (G, P-1, …), ``xattn`` (G, …), ``mlp``
(G, P, …), adapters alike; the dense cache is (G, P-1, batch, …).  The
stub vision frontend's patch embeddings ``image_embeds`` (B, n_image_tokens,
d_image) are cast to the model dtype and projected by ``img_proj``
(d_image, d) in every forward, prefill and decode step, and every decode
step projects the cross layers' K/V from them again, as the reference does.
Only the self layers carry a KV cache, and it is dense (no paged layout).

The hybrid family (jamba) stacks its layers in groups of
``P = hybrid_period``: one attention layer at ``hybrid_attn_index`` and
Mamba (``models/mamba.py``) at the other P-1 positions, each followed by
its FFN — routed experts at the odd positions, a gated MLP at the even
ones; the moe layers' load-balancing losses add up as the moe family's do.
Its leaves: ``ln_mixer``/``ln_ffn`` (G, P, d), ``attn`` (G, …), ``mamba``
(G, P-1, …), ``moe`` (G, P/2, …), ``mlp`` (G, P-P/2-1, …).  Its attention
layers get the KV cache (dense or paged) and its Mamba layers a recurrent
state, ``mamba`` {conv (G, P-1, B, dc-1, d_in), h (G, P-1, B, d_in, N)},
in every layout.  The ssm family (xlstm) stacks ``xlstm_pattern`` blocks
(mLSTM then sLSTM, ``models/xlstm.py``) a group: ``ln`` (G, 2, d),
``mlstm`` (G, …), ``slstm`` (G, …); its cache is recurrent state only, so
it has no paged layout.  A bucketed prefill's ``length`` reaches the
recurrent mixers, which keep the padding out of the state they leave.

Parameters keep the reference's stacked layout: every per-layer leaf under
``params["groups"]`` has a leading ``(n_layers,)`` axis, adapters included
(``groups["adapters"][module][proj]``).  The reference scans over that axis;
here a Python loop takes layer ``l``'s slice of every leaf (views, no
copies).  Decode caches are written in place.

Remat (``cfg.remat``, on by default as in the reference): a train forward
(``decoder_apply(train=True)`` with grad enabled) runs each group's body
under ``torch.utils.checkpoint`` (non-reentrant), and inside the vlm,
hybrid and ssm groups each position's mixer and FFN too, so the backward
keeps each group's input and recomputes the rest, one layer live at a time.
The recompute runs the same operations on the same inputs, so the loss and
every gradient are bitwise those without remat.  The vlm's gated cross layer
is left unwrapped inside its group, as in the reference.  Prefill, decode
and verify never checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.models import attention as attn_lib
from repro_torch.models import lane_state
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import normal, rms_norm, stacked_dense_init

Tree = Any


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _tslice(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _tslice(v, i) for k, v in tree.items()}
    return tree[i]


#: decoder families the port has: the same layer stack (moe: routed experts
#: in place of the MLP; vlm: groups of self layers and a gated cross layer;
#: hybrid: groups of Mamba layers and one attention layer; ssm: xLSTM blocks)
DECODER_FAMILIES = ("dense", "audio", "moe", "vlm", "hybrid", "ssm")

#: families whose attention layers the paged KV cache holds (vlm is served
#: through the lock-step dense cache only, as in the reference; ssm has no
#: attention layers)
PAGED_FAMILIES = ("dense", "audio", "moe", "hybrid")

#: families whose decode cache holds recurrent state beside (or instead of)
#: the KV cache
RECURRENT_FAMILIES = ("hybrid", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"unknown decoder family {cfg.family!r}")


def _embed_input(params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    """The stack's input: ``embeds`` (B, S, d) cast to the model dtype when
    given (audio frames), else the embedding rows of ``tokens``."""
    if embeds is not None:
        return embeds.to(torch_dtype(cfg.dtype))
    return params["embed"][tokens]


def _adp_for(
    adapters: Optional[Dict], module: str, seg_ids: Optional[torch.Tensor] = None
) -> Optional[Dict]:
    if not adapters or module not in adapters:
        return None
    # drop the rank metadata before handing the leaves to adapted_matmul
    out = {
        proj: {k: v for k, v in leaf.items() if k != "ranks"}
        for proj, leaf in adapters[module].items()
    }
    if seg_ids is not None:
        # multi-tenant serving: the "lam" leaf is the packed λ table
        # (n_slots, r) and each sequence takes its slot's row (BGMV path)
        for proj in out:
            out[proj]["seg"] = seg_ids
    return out


def gated_mlp(p: Dict, x: torch.Tensor, adp: Optional[Dict] = None) -> torch.Tensor:
    adp = adp or {}
    g = adapted_matmul(x, p["w_gate"], adp.get("w_gate"))
    u = adapted_matmul(x, p["w_up"], adp.get("w_up"))
    return adapted_matmul(F.silu(g) * u, p["w_down"], adp.get("w_down"))


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> Dict:
    """Random decoder params on the generator's device (same tree and
    distributions as the reference; torch draws its own numbers)."""
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    d, V, G = cfg.d_model, cfg.vocab_size, cfg.n_layers
    ones = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    down_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    if cfg.family == "vlm":
        return _init_vlm_params(gen, cfg, dtype, ones, down_scale)
    if cfg.family in RECURRENT_FAMILIES:
        return _init_recurrent_params(gen, cfg, dtype, ones, down_scale)
    groups = {
        "ln1": ones(G, d),
        "ln2": ones(G, d),
        "attn": attn_lib.init_attn_params(gen, cfg, G, dtype),
    }
    if cfg.is_moe:
        groups["moe"] = moe_lib.init_moe_params(gen, cfg, G, dtype)
    else:
        groups["mlp"] = {
            "w_gate": stacked_dense_init(gen, G, d, cfg.d_ff, dtype),
            "w_up": stacked_dense_init(gen, G, d, cfg.d_ff, dtype),
            "w_down": stacked_dense_init(gen, G, cfg.d_ff, d, dtype, scale=down_scale),
        }
    return {
        "embed": normal(gen, (V, d), 0.02, dtype),
        "final_norm": ones(d),
        "unembed": normal(gen, (d, V), d**-0.5, dtype),
        "groups": groups,
    }


def _lead(tree: Tree, *lead: int) -> Tree:
    """Every leaf's flat leading axis split into ``lead``."""
    if isinstance(tree, dict):
        return {k: _lead(v, *lead) for k, v in tree.items()}
    return tree.reshape(*lead, *tree.shape[1:])


def _init_vlm_params(gen: torch.Generator, cfg: ModelConfig, dtype, ones, down_scale) -> Dict:
    """The vlm tree (``repro/models/transformer.py:126-137``, ``:153-154``):
    G groups of P-1 self layers and one cross layer, the MLP and norms of
    all P, and the image projection ``img_proj`` (d_image, d)."""
    d, V, P = cfg.d_model, cfg.vocab_size, cfg.cross_attn_every
    G = cfg.n_layers // P
    groups = {
        "ln1": ones(G, P, d),
        "ln2": ones(G, P, d),
        "attn": _lead(attn_lib.init_attn_params(gen, cfg, G * (P - 1), dtype), G, P - 1),
        "xattn": attn_lib.init_attn_params(gen, cfg, G, dtype, cross=True),
        "mlp": _lead({
            "w_gate": stacked_dense_init(gen, G * P, d, cfg.d_ff, dtype),
            "w_up": stacked_dense_init(gen, G * P, d, cfg.d_ff, dtype),
            "w_down": stacked_dense_init(gen, G * P, cfg.d_ff, d, dtype, scale=down_scale),
        }, G, P),
    }
    return {
        "embed": normal(gen, (V, d), 0.02, dtype),
        "final_norm": ones(d),
        "unembed": normal(gen, (d, V), d**-0.5, dtype),
        "groups": groups,
        "img_proj": stacked_dense_init(gen, 1, cfg.d_image, d, dtype)[0],
    }


def _init_recurrent_params(gen: torch.Generator, cfg: ModelConfig, dtype, ones,
                           down_scale) -> Dict:
    """The hybrid and ssm trees (``repro/models/transformer.py:95-125``)."""
    d, V, P = cfg.d_model, cfg.vocab_size, cfg.group_size
    G = cfg.n_layers // P
    if cfg.family == "hybrid":
        n_mamba, n_moe, n_dense = P - 1, P // 2, P - P // 2 - 1
        groups = {
            "ln_mixer": ones(G, P, d),
            "ln_ffn": ones(G, P, d),
            "attn": attn_lib.init_attn_params(gen, cfg, G, dtype),
            "mamba": _lead(mamba_lib.init_mamba_params(gen, cfg, G * n_mamba, dtype),
                           G, n_mamba),
            "moe": _lead(moe_lib.init_moe_params(gen, cfg, G * n_moe, dtype), G, n_moe),
            "mlp": _lead({
                "w_gate": stacked_dense_init(gen, G * n_dense, d, cfg.d_ff, dtype),
                "w_up": stacked_dense_init(gen, G * n_dense, d, cfg.d_ff, dtype),
                "w_down": stacked_dense_init(gen, G * n_dense, cfg.d_ff, d, dtype,
                                             scale=down_scale),
            }, G, n_dense),
        }
    else:
        pat = cfg.xlstm_pattern
        groups = {"ln": ones(G, len(pat), d)}
        if "m" in pat:
            groups["mlstm"] = xlstm_lib.init_mlstm_params(gen, cfg, G, dtype)
        if "s" in pat:
            groups["slstm"] = xlstm_lib.init_slstm_params(gen, cfg, G, dtype)
    return {
        "embed": normal(gen, (V, d), 0.02, dtype),
        "final_norm": ones(d),
        "unembed": normal(gen, (d, V), d**-0.5, dtype),
        "groups": groups,
    }


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _image_rows(params, cfg: ModelConfig, x: torch.Tensor, image_embeds) -> Optional[torch.Tensor]:
    """The cross layers' key/value input: ``image_embeds`` (B, n_image_tokens,
    d_image) cast to x's dtype, times ``img_proj``, in x's dtype; None
    outside the vlm family."""
    if cfg.family != "vlm":
        return None
    if image_embeds is None:
        raise ValueError(f"{cfg.name}: the vlm family needs image_embeds (B, "
                         f"{cfg.n_image_tokens}, {cfg.d_image})")
    return (image_embeds.to(x.dtype) @ params["img_proj"]).to(x.dtype)


def _ckpt(fn: Callable, remat: bool) -> Callable:
    """``fn`` run under non-reentrant ``torch.utils.checkpoint`` when
    ``remat`` (the reference's ``_ckpt``, ``jax.checkpoint`` with nothing
    saveable): its backward recomputes what ``fn`` computed from the
    arguments it was given."""
    if not remat:
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _run_vlm_groups(params, cfg: ModelConfig, x, positions, cache_layers, img, remat=False):
    """The vlm group body (``repro/models/transformer.py:284-318``) over the
    G groups: P-1 self layers (adapters ``attn`` at [g, i]), then the gated
    cross layer (adapters ``xattn`` at [g]), each followed by its MLP (no
    adapters, as the reference's vlm body passes none)."""
    groups = params["groups"]
    P = cfg.cross_attn_every
    adapters = groups.get("adapters") or {}
    for g in range(cfg.n_layers // P):
        p = _tslice({k: v for k, v in groups.items() if k != "adapters"}, g)
        adp = _tslice(adapters, g) if adapters else None
        self_adp = _adp_for(adp, "attn")

        def group(x, p=p, g=g, adp=adp, self_adp=self_adp):
            for i in range(P - 1):
                h = rms_norm(x, p["ln1"][i], cfg.norm_eps)
                x = x + _ckpt(lambda h, i=i: attn_lib.attention(
                    _tslice(p["attn"], i), h, cfg, positions=positions,
                    adp=_tslice(self_adp, i) if self_adp else None,
                    cache=_tslice(_tslice(cache_layers["attn"], g), i) if cache_layers else None,
                ), remat)(h)
                h = rms_norm(x, p["ln2"][i], cfg.norm_eps)
                x = x + _ckpt(lambda h, i=i: gated_mlp(_tslice(p["mlp"], i), h), remat)(h)
            h = rms_norm(x, p["ln1"][P - 1], cfg.norm_eps)
            out = attn_lib.attention(p["xattn"], h, cfg, positions=positions,
                                     adp=_adp_for(adp, "xattn"), cross_kv=img)
            x = x + torch.tanh(p["xattn"]["xa_gate"]).to(x.dtype) * out
            h = rms_norm(x, p["ln2"][P - 1], cfg.norm_eps)
            return x + gated_mlp(_tslice(p["mlp"], P - 1), h)

        x = _ckpt(group, remat)(x)
    return x, None


def _store(state: Dict, new: Dict) -> None:
    """Write a mixer's new recurrent state into its cache slice, in place."""
    for k, t in new.items():
        state[k].copy_(t)


def _run_hybrid_groups(params, cfg: ModelConfig, x, positions, cache_layers, seg_ids,
                       attend_blocks, length, remat=False):
    """The hybrid group body (``repro/models/transformer.py:216-268``) over
    the G groups: at each of the P positions the attention layer (adapters
    ``attn`` at [g]; no ``n_valid``, as the reference passes none) or the
    next Mamba layer (adapters ``mamba`` at [g, i]), then the moe FFN at the
    odd positions and the gated MLP at the even ones (neither carries
    adapters in this family).  A group holds P-P/2-1 dense FFNs for its P/2 even positions: the last
    even position reads the last dense FFN again, as the reference's index
    past the end does (JAX clamps it).  Returns (x, the moe layers' summed
    aux loss)."""
    groups = params["groups"]
    P = cfg.hybrid_period
    n_dense = P - P // 2 - 1
    adapters = groups.get("adapters") or {}
    aux = None
    for g in range(cfg.n_layers // P):
        p = _tslice({k: v for k, v in groups.items() if k != "adapters"}, g)
        adp = _tslice(adapters, g) if adapters else None
        mam_adp = _adp_for(adp, "mamba", seg_ids)

        def group(x, p=p, g=g, adp=adp, mam_adp=mam_adp):
            aux = None
            mi = di = oi = 0
            for i in range(P):
                h = rms_norm(x, p["ln_mixer"][i], cfg.norm_eps)
                if i == cfg.hybrid_attn_index:
                    out = _ckpt(lambda h: attn_lib.attention(
                        p["attn"], h, cfg, positions=positions,
                        adp=_adp_for(adp, "attn", seg_ids),
                        cache=_tslice(cache_layers["attn"], g) if cache_layers else None,
                        attend_blocks=attend_blocks), remat)(h)
                else:
                    st = _tslice(_tslice(cache_layers["mamba"], g), mi) if cache_layers else None
                    a_i = ({w: {k: (t if k == "seg" else t[mi]) for k, t in leaf.items()}
                            for w, leaf in mam_adp.items()} if mam_adp else None)
                    out, ns = _ckpt(lambda h, mi=mi, st=st, a_i=a_i: mamba_lib.mamba_mixer(
                        _tslice(p["mamba"], mi), h, cfg, state=st, adp=a_i, length=length),
                        remat)(h)
                    if ns is not None:
                        _store(st, ns)
                    mi += 1
                x = x + out
                h = rms_norm(x, p["ln_ffn"][i], cfg.norm_eps)
                if i % 2 == 1:
                    y, a = _ckpt(lambda h, oi=oi: moe_lib.moe_ffn(_tslice(p["moe"], oi), h, cfg),
                                 remat)(h)
                    aux = a if aux is None else aux + a
                    oi += 1
                else:
                    y = _ckpt(lambda h, di=di: gated_mlp(_tslice(p["mlp"], min(di, n_dense - 1)),
                                                         h), remat)(h)
                    di += 1
                x = x + y
            return x, aux

        x, a = _ckpt(group, remat)(x)
        aux = a if aux is None else aux + a
    return x, aux


def _run_ssm_groups(params, cfg: ModelConfig, x, cache_layers, seg_ids, length, remat=False):
    """The ssm group body (``repro/models/transformer.py:270-297``) over the
    G groups: each block of ``xlstm_pattern`` (adapters ``mlstm``/``slstm``
    at [g]) as a pre-norm residual."""
    groups = params["groups"]
    adapters = groups.get("adapters") or {}
    mixers = {"m": ("mlstm", xlstm_lib.mlstm_mixer), "s": ("slstm", xlstm_lib.slstm_mixer)}
    for g in range(cfg.n_layers // cfg.group_size):
        p = _tslice({k: v for k, v in groups.items() if k != "adapters"}, g)
        adp = _tslice(adapters, g) if adapters else None

        def group(x, p=p, g=g, adp=adp):
            for j, kind in enumerate(cfg.xlstm_pattern):
                key, mixer = mixers[kind]
                h = rms_norm(x, p["ln"][j], cfg.norm_eps)
                st = _tslice(cache_layers[key], g) if cache_layers else None
                out, ns = _ckpt(lambda h, key=key, mixer=mixer, st=st: mixer(
                    p[key], h, cfg, state=st, adp=_adp_for(adp, key, seg_ids), length=length),
                    remat)(h)
                if ns is not None:
                    _store(st, ns)
                x = x + out
            return x

        x = _ckpt(group, remat)(x)
    return x, None


def _run_layers(params, cfg, x, positions, cache_layers, seg_ids=None, attend_blocks=None,
                n_valid=None, img=None, length=None, remat=False):
    """The layer stack over ``x`` → ``(x, aux)``: ``aux`` sums the moe
    layers' load-balancing losses (None for the families without).
    ``img``: the vlm family's projected image rows (:func:`_run_vlm_groups`);
    ``length``: a bucketed prefill's true lengths, for the recurrent
    mixers; ``remat``: checkpoint each group (module docstring)."""
    if cfg.family == "vlm":
        return _run_vlm_groups(params, cfg, x, positions, cache_layers, img, remat)
    if cfg.family == "hybrid":
        return _run_hybrid_groups(params, cfg, x, positions, cache_layers, seg_ids,
                                  attend_blocks, length, remat)
    if cfg.family == "ssm":
        return _run_ssm_groups(params, cfg, x, cache_layers, seg_ids, length, remat)
    groups = params["groups"]
    aux = None
    adapters = groups.get("adapters")
    for l in range(cfg.n_layers):
        p = _tslice({k: v for k, v in groups.items() if k != "adapters"}, l)
        adp = _tslice(adapters, l) if adapters else None

        def layer(x, p=p, l=l, adp=adp):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + attn_lib.attention(
                p["attn"], h, cfg, positions=positions,
                adp=_adp_for(adp, "attn", seg_ids),
                cache=_tslice(cache_layers["attn"], l) if cache_layers else None,
                attend_blocks=attend_blocks, n_valid=n_valid,
            )
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            a = None
            if cfg.is_moe:
                y, a = moe_lib.moe_ffn(p["moe"], h, cfg)
            else:
                y = gated_mlp(p["mlp"], h, _adp_for(adp, "mlp", seg_ids))
            return x + y, a

        x, a = _ckpt(layer, remat)(x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["unembed"].float()  # fp32 logits, as the reference


def decoder_apply(params, cfg: ModelConfig, tokens=None, seg_ids=None, embeds=None,
                  image_embeds=None, train: bool = False):
    """Full-sequence forward of ``tokens`` (B, S) or ``embeds`` (B, S, d) →
    ``(logits (B, S, V) fp32, aux)``: ``aux`` the layers' summed moe
    load-balancing loss, a float32 0 for the other families.  The vlm
    family takes ``image_embeds`` (B, n_image_tokens, d_image).  A
    ``train`` forward with grad enabled remats when ``cfg.remat``."""
    x = _embed_input(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = train and cfg.remat and torch.is_grad_enabled()
    x, aux = _run_layers(params, cfg, x, positions, None, seg_ids,
                         img=_image_rows(params, cfg, x, image_embeds), remat=remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


def init_decode_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
    per_lane: bool = False, paged: bool = False, block_size: int = 16,
    n_blocks: Optional[int] = None, device=None,
) -> Dict:
    """Decode cache.

    Default: the lock-step dense cache the merged-weight reference decodes
    with — k/v ``(n_layers, batch, max_len, KV, dh)`` and one scalar offset
    per layer.  ``per_lane=True``: the same dense k/v with a write offset
    per lane (``idx`` (n_layers, batch), ``pos`` (batch,)), so lanes hold
    sequences of different lengths — the oracle-dense serving layout.
    ``paged=True`` (implies per-lane): a global block pool
    ``(n_layers, n_blocks, block_size, KV, dh)`` and per-lane block tables
    ``(n_layers, batch, max_len / block_size)`` int32 in place of the dense
    region; block 0 is the reserved trash block (``serving/paging.py``).
    The vlm family's dense cache holds its self layers only, under two lead
    axes (G, P-1); it has no paged layout.  The hybrid family's KV cache
    holds its G attention layers, beside the Mamba layers' recurrent state;
    the ssm family's cache is recurrent state only, and it refuses
    ``paged=True`` (there is none to page).
    """
    _check_family(cfg)
    KV, dh = cfg.n_kv_heads, cfg.d_head
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    if paged and cfg.family not in PAGED_FAMILIES:
        if cfg.family == "ssm":
            raise NotImplementedError(
                f"paged KV cache needs attention layers; family {cfg.family!r} has none to "
                "page (its per-lane state is already O(1) — use per_lane=True)")
        raise NotImplementedError(
            f"paged KV cache: family {cfg.family!r} is served through the dense cache "
            "only, as in the reference")
    lead = _kv_lead(cfg)
    recurrent = _recurrent_layer_states(cfg, batch, dtype, device)
    if not paged:
        lanes = (batch,) if per_lane else ()
        layers = dict(recurrent)
        if cfg.family != "ssm":
            layers["attn"] = {
                "k": zeros(*lead, batch, max_len, KV, dh),
                "v": zeros(*lead, batch, max_len, KV, dh),
                "idx": zeros(*lead, *lanes, dt=torch.int32),
            }
        return {"pos": zeros(*lanes, dt=torch.int32), "layers": layers}
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} must be a multiple of block_size={block_size}")
    max_blocks = max_len // block_size
    if n_blocks is None:
        n_blocks = 1 + batch * max_blocks  # worst case + trash block
    return {
        "pos": zeros(batch, dt=torch.int32),
        "layers": {"attn": {
            "k": zeros(*lead, n_blocks, block_size, KV, dh),
            "v": zeros(*lead, n_blocks, block_size, KV, dh),
            "block_tbl": zeros(*lead, batch, max_blocks, dt=torch.int32),
            "idx": zeros(*lead, batch, dt=torch.int32),
        }, **recurrent},
    }


def _recurrent_layer_states(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    """The recurrent per-layer decode states of a family
    (``repro/models/transformer.py:398-416``): Mamba ``{conv, h}`` (G, P-1,
    batch, …) for hybrid, the mLSTM and sLSTM states (G, batch, …) for ssm,
    none for the others.  O(1) a lane, the same in every cache layout."""
    G = cfg.n_layers // cfg.group_size
    if cfg.family == "hybrid":
        return {"mamba": mamba_lib.init_mamba_state(cfg, batch, (G, cfg.hybrid_period - 1),
                                                    dtype, device)}
    layers = {}
    if cfg.family == "ssm":
        if "m" in cfg.xlstm_pattern:
            layers["mlstm"] = xlstm_lib.init_mlstm_state(cfg, batch, (G,), dtype, device)
        if "s" in cfg.xlstm_pattern:
            layers["slstm"] = xlstm_lib.init_slstm_state(cfg, batch, (G,), dtype, device)
    return layers


def _kv_lead(cfg: ModelConfig) -> tuple:
    """Lead axes of the KV cache: (n_layers,), the vlm family's (G, P-1)
    self layers, or the hybrid family's G attention layers."""
    if cfg.family == "vlm":
        P = cfg.cross_attn_every
        return (cfg.n_layers // P, P - 1)
    return (cfg.n_layers // cfg.group_size,)


def decode_state_lane_axes(cfg: ModelConfig, paged: bool = False) -> Dict:
    """LaneState protocol: the lane axis of each leaf of the per-lane cache
    (``init_decode_state(..., per_lane=True, paged=paged)``): after the
    lead axes, one for most families, two (G, P-1) for vlm and for the
    hybrid's Mamba states."""
    _check_family(cfg)
    layers = {}
    if cfg.family == "hybrid":
        layers["mamba"] = mamba_lib.state_lane_axes(2)
    elif cfg.family == "ssm":
        if "m" in cfg.xlstm_pattern:
            layers["mlstm"] = xlstm_lib.mlstm_state_lane_axes(1)
        if "s" in cfg.xlstm_pattern:
            layers["slstm"] = xlstm_lib.slstm_state_lane_axes(1)
    if paged:
        if cfg.family not in PAGED_FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} has no attention layers to page")
        layers["attn"] = attn_lib.paged_kv_lane_axes()
    elif cfg.family != "ssm":
        layers["attn"] = attn_lib.kv_lane_axes(len(_kv_lead(cfg)))
    return {"pos": 0, "layers": layers}


def paged_prefill_view(cfg: ModelConfig, cache, write_ids: torch.Tensor,
                       read_ids: Optional[torch.Tensor] = None) -> Dict:
    """1-lane paged-cache view for block-aligned admission prefill: it
    aliases the engine cache's pools, and its single block-table row is
    ``write_ids`` (ceil(bucket / block_size),) — this pass's write targets,
    trash block 0 standing in for cached prefix blocks and bucket padding.

    ``read_ids`` (ceil(bucket / block_size),) switches the view to chunked
    prefill: attention gathers its keys back out of the pool through this
    row — the request's own blocks and any adopted prefix-cache blocks — so
    a chunk sees every earlier chunk's K/V under the absolute causal mask."""
    a = cache["layers"]["attn"]
    G = a["idx"].shape[0]
    dev = a["idx"].device
    attn = {
        "k": a["k"],
        "v": a["v"],
        "block_tbl": write_ids.to(torch.int32).expand(G, 1, -1),
        "idx": torch.zeros((G, 1), dtype=torch.int32, device=dev),
    }
    if read_ids is not None:
        attn["read_tbl"] = read_ids.to(torch.int32).expand(G, 1, -1)
    # recurrent layers (hybrid's Mamba) get a fresh 1-lane state, which the
    # prefill fills with the prompt's
    return {"pos": torch.zeros((1,), dtype=torch.int32, device=dev),
            "layers": {"attn": attn,
                       **_recurrent_layer_states(cfg, 1, a["k"].dtype, dev)}}


def commit_paged_prefill(cfg: ModelConfig, cache, filled, lane: int,
                         table_row: torch.Tensor, length: int) -> Dict:
    """Adopt a block-aligned prefill into lane ``lane``: the view already
    wrote the pools in place; point the lane's block-table row at its blocks
    (``table_row`` (max_blocks,), tail entries trash block 0), set its
    offsets to the true prompt ``length`` and splice the recurrent layers'
    states (hybrid's Mamba) from the 1-lane view into the lane
    (``lane_state.restore_lane``).  ``filled`` is None where no prefill ran
    (a shipped prefill of a family without recurrent layers)."""
    a = cache["layers"]["attn"]
    cache["pos"][lane] = length
    a["block_tbl"][:, lane, :] = table_row.to(torch.int32)
    a["idx"][:, lane] = length
    axes = decode_state_lane_axes(cfg, paged=True)["layers"]
    for key in cache["layers"]:
        if key != "attn":
            lane_state.restore_lane(cache["layers"][key], axes[key], lane,
                                    filled["layers"][key])
    return cache


def decoder_prefill(params, cfg: ModelConfig, cache, tokens=None, seg_ids=None, length=None,
                    start=None, embeds=None, image_embeds=None):
    """Fill the cache with a prompt; returns (last-position logits (B,V),
    cache).  ``length`` (int (B,)) marks the true prompt length when
    ``tokens`` is right-padded to a bucket: logits come from row
    ``length - 1`` and the offsets are set to ``length``.

    ``start`` (int) marks ``tokens`` as one chunk of a chunked paged prefill
    beginning at that absolute position: RoPE and the causal mask run at
    ``start + arange(S)``, and the logits row is ``length - 1 - start``
    (clamped into the chunk: meaningful on the final chunk only).  The cache
    must then be a ``paged_prefill_view`` carrying ``read_ids``.  ``embeds``
    (B, S, d) stands in for ``tokens`` (audio frames); the vlm family takes
    ``image_embeds``."""
    x = _embed_input(params, cfg, tokens, embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if start is not None:
        positions = positions + int(start)
    if length is not None:
        length = torch.as_tensor(length, dtype=torch.int32, device=x.device)
    x, _ = _run_layers(params, cfg, x, positions, cache["layers"], seg_ids,
                       img=_image_rows(params, cfg, x, image_embeds), length=length)
    attn = cache["layers"].get("attn")
    if length is None:
        x_last = x[:, -1:]
        cache["pos"].fill_(S)
        if attn is not None:
            attn["idx"].fill_(S)
    else:
        row = length.long() - 1
        if start is not None:
            row = torch.clamp(row - int(start), 0, S - 1)
        x_last = torch.gather(x, 1, row[:, None, None].expand(-1, 1, x.shape[-1]))
        cache["pos"][...] = length
        if attn is not None:
            attn["idx"][...] = length
    return _logits(params, cfg, x_last)[:, 0], cache


def decoder_decode(params, cfg: ModelConfig, cache, token=None, seg_ids=None,
                   attend_blocks=None, embeds=None, image_embeds=None):
    """One decode step; ``token`` (B, 1) int, or ``embeds`` (B, 1, d).
    ``attend_blocks`` bounds the paged attend to the table's first
    that-many columns.  The vlm family takes ``image_embeds`` at every step
    and projects them again, as the reference does."""
    x = _embed_input(params, cfg, token, embeds)
    pos = cache["pos"]
    positions = pos[None] if pos.ndim == 0 else pos[:, None]
    x, _ = _run_layers(params, cfg, x, positions, cache["layers"], seg_ids, attend_blocks,
                       img=_image_rows(params, cfg, x, image_embeds))
    cache["pos"] += 1
    if "attn" in cache["layers"]:
        cache["layers"]["attn"]["idx"] += 1
    return _logits(params, cfg, x)[:, 0], cache


def decoder_verify(params, cfg: ModelConfig, cache, tokens, seg_ids=None, n_valid=None,
                   attend_blocks=None):
    """Speculative verify: one forward over ``tokens`` (B, W) — each lane's
    last committed token followed by its drafted continuation — at absolute
    positions ``pos[b] .. pos[b]+W-1`` of a per-lane (dense or paged)
    cache, returning the logits of all W rows, (B, W, V) fp32.

    Row ``s`` attends to every cache position ``<= pos+s`` (the window's own
    earlier rows included, written first), so its logits are what
    :func:`decoder_decode` computes after committing the window's first
    ``s`` tokens: greedy acceptance is prefix equality against the per-row
    argmax.  ``n_valid`` (int (B,)) caps the rows each lane writes into its
    cache (0 for idle lanes).  The offsets (``pos``/``idx``) are left
    unchanged: the serving engine advances them by each lane's accepted
    length, then rolls back the paged blocks the acceptance did not reach."""
    x = params["embed"][tokens]
    W = x.shape[1]
    positions = cache["pos"][:, None] + torch.arange(W, device=x.device)[None, :]
    x, _ = _run_layers(params, cfg, x, positions, cache["layers"], seg_ids, attend_blocks,
                    n_valid=n_valid)
    return _logits(params, cfg, x), cache
