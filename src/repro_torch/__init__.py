"""PyTorch/CUDA port of the QR-LoRA system (``repro`` is the JAX reference).

The port keeps the reference's module layout, parameter trees and stacked
``(n_layers, K, N)`` weight layout with ``x @ W`` orientation, so weights
cross over leaf for leaf (:mod:`repro_torch.interop`).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  Nothing here imports
``jax`` or ``repro``.

Slice covered so far: multi-tenant serving of a dense QR-LoRA decoder
through the paged KV cache, with hand-written Hopper kernels for the
batched multi-λ matmul (:mod:`repro_torch.kernels.qrlora_bgmv`) and paged
decode attention (:mod:`repro_torch.kernels.paged_attention`).
"""
from repro_torch.device import resolve_device
