"""Attention entry point over flattened 2D/3D token grids (BSHD layout).

Counterpart of ``medical_image_generation_tpu/ops/attention.py``. The JAX
dispatcher keeps XLA attention below S = 8192 or above D = 512 and falls
back on any kernel error; those gates came from TPU layout pinning. Here
every call goes to the hand-written flash kernel on a CUDA tensor, to its
plain version on a CPU tensor, and raises on anything the kernel cannot
take: no size gate, no environment switch, no fallback. Sequence-parallel
ring attention is not ported yet.
"""

from __future__ import annotations

from typing import Optional

from medical_image_generation_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Full (unmasked) scaled dot-product attention, BSHD in and out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_attention(q, k, v, float(scale))[0]
