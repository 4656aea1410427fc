"""PyTorch/CUDA port of the QR-LoRA system (``repro`` is the JAX reference).

The port keeps the reference's module layout, parameter trees and stacked
``(n_layers, K, N)`` weight layout with ``x @ W`` orientation, so weights
cross over leaf for leaf (:mod:`repro_torch.interop`).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  Nothing here imports
``jax`` or ``repro``.

Paths covered so far, on a dense QR-LoRA decoder: multi-tenant serving
through the paged KV cache, with hand-written Hopper kernels for the
batched multi-λ matmul (:mod:`repro_torch.kernels.qrlora_bgmv`) and paged
decode attention (:mod:`repro_torch.kernels.paged_attention`); and λ-only
training (:mod:`repro_torch.training`), whose adapted projections run the
one-λ matmul kernel (:mod:`repro_torch.kernels.qrlora_matmul`) under a
hand-written backward.
"""
from repro_torch.device import resolve_device
