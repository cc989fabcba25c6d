"""PyTorch / CUDA port of medimgen-tpu for one NVIDIA H100.

A second package beside the JAX reference (``medical_image_generation_tpu``),
checked against it module by module. It imports ``torch`` and never JAX or
anything of the JAX package: host-side helpers it needs (planner math, the
config loader) are kept here as its own copies.

Layout: public functions take and return the JAX package's layout
(B, *spatial, C). Inside, activations are NCDHW tensors in
``torch.channels_last_3d`` memory, i.e. contiguous (B, Z*Y*X, C) buffers,
which is the operand the hand-written GroupNorm kernels read in place.

Hand-written Hopper kernels (``csrc/``): ``ops/kernels.py`` is their table
(source, C entry point, device names, launch counters), and each has a
wrapper with a plain PyTorch twin in ``ops/flash_attention.py``,
``ops/groupnorm.py`` or ``ops/adamw.py``. A wrapper given a CUDA tensor
launches its kernel or raises; the plain version runs only for CPU tensors.

Several cards: one process a card under torchrun, on the (data, model) mesh
of ``parallel/`` (``mesh.py``, ``comm.py``, ``sharding.py``), with ring
attention over the model axis (``ops/ring_attention.py``) on the flash
kernels.
"""
