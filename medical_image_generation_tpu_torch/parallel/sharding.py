"""Tensor-parallel (Megatron) layout of the U-Net and the VAE over the
mesh's 'model' axis.

Port of ``medical_image_generation_tpu/parallel/sharding.py`` (:24-127).
JAX annotates the param tree and GSPMD inserts the collectives; the port
stores only this rank's shard of each sharded parameter and runs the
collectives itself (``parallel/comm.py``), inside the blocks' forward
(``models/blocks.py``: ``ResBlock`` and ``AttentionBlock`` take the
model-parallel path when their ``tp`` is set):

* ResBlock: ``ConvND_0`` and the time projection ``Dense_0`` are
  column-parallel (this rank's output channels; their input enters through
  ``copy``, identity forward and all-reduce backward); ``ConvND_1`` is
  row-parallel (this rank's input channels; the partial sums are
  all-reduced (``reduce``) before its bias);
* AttentionBlock: the fused qkv projection ``Dense_0`` is column-parallel,
  the output projection ``Dense_1`` row-parallel;
* everything else (norms, shortcuts, embeddings, the output conv, the
  SpatialTransformers) is replicated: every rank holds it whole and
  computes it alike.

``_spec_for_path`` is the JAX rule on the port's parameter names (torch's
axis order: a conv weight is (out, in, *k), a linear weight (out, in)), and
``param_spec`` replicates a leaf whose sharded dimension does not divide,
as JAX's ``unet_param_shardings`` does. Three traps the port handles
itself, where GSPMD handles them silently:

* ``ResBlock.GroupNorm_1`` normalises ``ConvND_0``'s column-sharded output.
  It is local only when its groups divide over the axis
  (``norm_num_groups % n == 0``): then each rank normalises its channels
  as ``groups / n`` groups, and its scale and bias are stored as the
  matching shard (JAX keeps them replicated and GSPMD slices them at use).
  Otherwise the whole ResBlock stays replicated. A block is sharded whole
  or not at all (``block_layout``): the port's collectives are per block,
  where GSPMD may mix sharded and replicated leaves.
* The fused qkv ``Dense_0`` is 3C wide, and a contiguous shard of it does
  not align with q / k / v. The rank gathers the projected features
  (``gather``: the backward takes its slice, with no sum) and runs
  attention on the whole q, k, v (the ring, when the gate opens), then
  feeds the row-parallel ``Dense_1`` its own input slice (``scatter``).
  Correct and simple; the gather is the cost.
* The EMA copy and the AdamW moments follow the params' layout (they are
  made from the sharded params), as ``train_state_shardings`` places
  them; ``gather_full`` / ``local_shards`` move them between the rank's
  shards and the full tensors a checkpoint holds, so a checkpoint loads
  under any (data, model) layout.

The trainers' gradient norm adds the sharded leaves' squares over the model
axis and counts replicated leaves once (``ops/adamw.py`` ``global_norm``
and, on CUDA, ``sq_norm``'s two sums).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, ResBlock
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup

MODEL = "model"


def _spec_for_path(name: str, ndim: int) -> tuple:
    """The JAX rule (``sharding.py:27-69``) on a port parameter name: a
    tuple over the parameter's axes, "model" on the sharded one."""
    names = name.split(".")
    joined = "/".join(names)
    leaf = names[-1]
    rep = (None,) * ndim

    def col():  # output features: dim 0 of a torch conv or linear weight
        return (MODEL,) + (None,) * (ndim - 1)

    def row():  # input features: dim 1
        return rep if ndim < 2 else (None, MODEL) + (None,) * (ndim - 2)

    if any("ResBlock" in n for n in names):
        if "ConvND_0" in joined and leaf == "weight":
            return col()
        if "Dense_0" in joined and leaf == "weight":
            return col()
        if ("ConvND_0" in joined or "Dense_0" in joined) and leaf == "bias":
            return (MODEL,)
        if "ConvND_1" in joined and leaf == "weight":
            return row()
        return rep
    if any("AttentionBlock" in n or "CrossAttention" in n for n in names):
        if "Dense_0" in joined and leaf == "weight":
            return col()
        if "Dense_0" in joined and leaf == "bias":
            return (MODEL,)
        if "Dense_1" in joined and leaf == "weight":
            return row()
        return rep
    return rep


def param_spec(name: str, shape: Sequence[int], n_model: int) -> tuple:
    """``_spec_for_path``, replicated when the sharded dimension does not
    divide over ``n_model`` ranks (JAX ``unet_param_shardings``)."""
    spec = _spec_for_path(name, len(shape))
    if n_model > 1 and any(a == MODEL and d % n_model for a, d in zip(spec, shape)):
        return (None,) * len(shape)
    return spec


def block_layout(module: torch.nn.Module, n_model: int) -> Dict[str, int]:
    """{parameter name: sharded dim} of the blocks of ``module`` that shard
    whole over ``n_model`` ranks: each ``ResBlock`` whose output channels
    and GroupNorm groups divide (its ``GroupNorm_1`` scale and bias with
    it), each ``AttentionBlock`` whose channels divide. The
    SpatialTransformers' attentions stay replicated."""
    layout: Dict[str, int] = {}
    if n_model < 2:
        return layout
    for prefix, mod in module.named_modules():
        if isinstance(mod, ResBlock):
            gn = mod.GroupNorm_1
            ok = gn.weight.shape[0] % n_model == 0 and gn.num_groups % n_model == 0
        elif isinstance(mod, AttentionBlock):
            ok = mod.Dense_1.weight.shape[0] % n_model == 0
        else:
            continue
        specs = {}
        for name, p in mod.named_parameters():
            full = f"{prefix}.{name}"
            specs[full] = param_spec(full, p.shape, n_model)
            ok = ok and specs[full] == _spec_for_path(full, p.dim())
        if not ok:
            continue
        for name, spec in specs.items():
            if MODEL in spec:
                layout[name] = spec.index(MODEL)
        if isinstance(mod, ResBlock):
            layout[f"{prefix}.GroupNorm_1.weight"] = 0
            layout[f"{prefix}.GroupNorm_1.bias"] = 0
    return layout


def _keep_format(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in the channels-last format of a 4-D / 5-D conv
    weight (the format ``ConvND`` keeps), else row-major."""
    if t.dim() == 5:
        return t.contiguous(memory_format=torch.channels_last_3d)
    if t.dim() == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


@torch.no_grad()
def shard_module_(module: torch.nn.Module, mesh) -> Dict[str, int]:
    """Put ``module`` in the Megatron layout over ``mesh``'s model axis, in
    place: each sharded parameter keeps only this rank's slice, and each
    sharded block gets ``tp`` (its ``AxisGroup``). Call it on the whole
    (replicated) module, alike on every rank, before an optimizer or EMA is
    made from its parameters. Returns the layout {name: sharded dim} (empty
    for a model axis of one rank)."""
    axis = AxisGroup.of(mesh, "model")
    layout = block_layout(module, axis.size)
    if not layout:
        return layout
    for name, dim in layout.items():
        owner, leaf = module.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
        p = getattr(owner, leaf)
        # a new Parameter, not new .data: autograd keeps a leaf's shape
        setattr(owner, leaf, torch.nn.Parameter(_keep_format(axis.local(p.detach(), dim)),
                                                requires_grad=p.requires_grad))
    for prefix, mod in module.named_modules():
        if isinstance(mod, (ResBlock, AttentionBlock)) and any(
                n.startswith(prefix + ".") for n in layout):
            mod.tp = axis
    return layout


def gather_full(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                mesh) -> list:
    """The full tensors of a list of this rank's shards (``dims``: each
    one's sharded dim, or None for a replicated one), all-gathered over the
    model axis; replicated ones as they are. Every rank of the model row
    must call it alike."""
    axis = AxisGroup.of(mesh, "model")
    return [t if d is None else axis.all_gather(t.contiguous(), d)
            for t, d in zip(tensors, dims)]


def local_shards(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                 mesh) -> list:
    """This rank's slices of full tensors (the inverse of ``gather_full``)."""
    axis = AxisGroup.of(mesh, "model")
    return [t if d is None else axis.local(t, d) for t, d in zip(tensors, dims)]


def full_state_dict(module: torch.nn.Module, layout: Dict[str, int], mesh) -> Dict:
    """``module.state_dict()`` with every sharded entry gathered whole,
    copied to the CPU."""
    sd = module.state_dict()
    names = list(sd)
    full = gather_full([sd[n].detach() for n in names], [layout.get(n) for n in names], mesh)
    return {n: t.cpu() for n, t in zip(names, full)}


def local_state_dict(state: Dict, layout: Dict[str, int], mesh) -> Dict:
    """This rank's shards of a full state dict (a checkpoint's)."""
    names = list(state)
    return dict(zip(names, local_shards([state[n] for n in names],
                                        [layout.get(n) for n in names], mesh)))
