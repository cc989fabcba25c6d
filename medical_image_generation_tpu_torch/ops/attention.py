"""Attention entry point over flattened 2D/3D token grids (BSHD layout).

Counterpart of ``medical_image_generation_tpu/ops/attention.py``. The JAX
dispatcher keeps XLA attention below S = 8192 or above D = 512 and falls
back on any kernel error; those gates came from TPU layout pinning. Here a
call goes to the hand-written flash kernel on a CUDA tensor, to its plain
version on a CPU tensor, and raises on anything the kernel cannot take: no
size gate, no fallback.

Sequence-parallel ring attention (``ops/ring_attention.py``) takes the call
instead under the JAX gate (``:72-102``): an active mesh (``with mesh:``,
``parallel/mesh.py``) whose model axis has n > 1 ranks, S >
``MEDIMGEN_RING_MIN_SEQ`` (default 32768, strict, read at every call),
S % n == 0, and q, k and v of one shape. The activations around attention
are whole on every rank of the model axis, so the ring takes this rank's
S/n rows and all-gathers the output rows (``ring_attention_sharded``).
"""

from __future__ import annotations

import os
from typing import Optional

from medical_image_generation_tpu_torch.ops import ring_attention
from medical_image_generation_tpu_torch.ops.flash_attention import flash_attention
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup
from medical_image_generation_tpu_torch.parallel.mesh import active_mesh


def _ring_min_seq() -> int:
    """Token count above which the ring engages (strict '>'): one card
    takes the flagship 32^3-latent grid, so exactly 32^3 tokens stay on the
    single-card kernels."""
    return int(os.environ.get("MEDIMGEN_RING_MIN_SEQ", 32768))


def _active_model_mesh():
    """The active mesh, when its 'model' axis has more than one rank."""
    m = active_mesh()
    return m if m is not None and m.shape["model"] > 1 else None


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Full (unmasked) scaled dot-product attention, BSHD in and out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mesh = _active_model_mesh()
    if (mesh is not None and q.shape[1] > _ring_min_seq()
            and q.shape[1] % mesh.shape["model"] == 0 and q.shape == k.shape == v.shape):
        return ring_attention.ring_attention_sharded(q, k, v, AxisGroup.of(mesh, "model"),
                                                     float(scale))
    return flash_attention(q, k, v, float(scale))[0]
