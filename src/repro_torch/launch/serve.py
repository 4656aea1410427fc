"""Batched serving launcher: prefill a batch of prompts, decode N tokens
(port of ``repro/launch/serve.py``: the same flags plus ``--device``, the
same printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --reduced --device cpu

The last form serves full-width llama-3.2-vision-11b on the card (random
weights from ``--seed``): one lock-step dense cache, greedy decoding, every
adapted projection through the one-λ kernel.  It works for every
decoder family the port has (the recurrent families keep their lanes' state
in the same cache); a vlm batch carries patch embeddings beside
its prompts, zeros here as in the reference's launcher (the vision frontend is
a stub).  The params keep their adapters (λ = 0 at init), as the
reference's launcher serves them.  :func:`generate` is the loop itself, for
callers that bring their own params, prompts and images.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import torch_dtype
from repro_torch.training import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params, prompts, image_embeds=None, gen_len: int = 32,
             keep_logits: bool = False) -> Dict:
    """Prefill ``prompts`` (B, P) int and decode greedily: the first token
    from the prefill's last-position logits, then ``gen_len - 1`` decode
    steps, each feeding its argmax to the next, over one lock-step dense
    cache of ``P + gen_len`` positions in the model dtype (bfloat16 or
    float32).  ``image_embeds`` (B, n_image_tokens, d_image) goes with
    every step of a vlm model.  Returns ``{"tokens"}`` (B, gen_len) int32
    numpy, the prefill's and the decode steps' seconds (each ended by a
    device sync), and with ``keep_logits`` the fp32 ``"logits"`` (B,
    gen_len, V) on the device: row t scored token t."""
    cfg, dev = model.cfg, model.device
    prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    B, P = prompts.shape
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    cache = model.init_decode_state(B, P + gen_len, torch_dtype(cfg.dtype))
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["image_embeds"] = image_embeds
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cache, batch)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks, rows = [tok], [logits]
        t1 = time.perf_counter()
        for _ in range(gen_len - 1):
            db = {"token": tok}
            if cfg.family == "vlm":
                db["image_embeds"] = image_embeds
            tok, logits, cache = decode(params, cache, db)
            toks.append(tok)
            rows.append(logits)
        _sync(dev)
        t_decode = time.perf_counter() - t1
    out = {"tokens": torch.cat(toks, dim=1).cpu().numpy(), "prefill_s": t_prefill,
           "decode_s": t_decode}
    if keep_logits:
        out["logits"] = torch.stack(rows, dim=1).float()
    return out


def main(argv=None) -> np.ndarray:
    """The launcher; returns the generated tokens (batch, gen_len)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    model = build_model(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(args.seed))

    B, P, G = args.batch, args.prompt_len, args.gen_len
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)
    images: Optional[torch.Tensor] = None
    if cfg.family == "vlm":
        images = torch.zeros((B, cfg.n_image_tokens, cfg.d_image), dtype=torch.bfloat16,
                             device=model.device)
    out = generate(model, params, prompts, images, G)
    gen, t_prefill, t_decode = out["tokens"], out["prefill_s"], out["decode_s"]
    print(f"[serve] arch={cfg.name} batch={B} prompt={P} gen={G}")
    print(f"[serve] prefill: {t_prefill*1e3:.1f} ms ({B*P/t_prefill:.0f} tok/s)")
    print(f"[serve] decode:  {t_decode*1e3:.1f} ms ({B*(G-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"[serve] sample continuation[0,:16]: {gen[0,:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
