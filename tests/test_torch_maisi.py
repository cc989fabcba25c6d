"""PyTorch port, MAISI's diffusion U-Net (the region and spacing embeddings,
heads of a fixed width) and the LDM trainer on precomputed latents, against
the benchmark's plain float32 reference (``benchmark/reference/maisi.py``)
on the CPU, in float32, on seeded random weights, at a tiny width:
[16, 32, 32, 64], heads of 8 channels, a 16^3 latent of 4 channels, batch 2.
Imports no JAX.

Tolerances: both sides compute in float32 and differ only in the order of
their sums (the port's plain GroupNorm and flash attention, channels-last
convolutions, the reference's ``torch.nn.functional`` calls), which moves a
result by a few float32 ulps of the sums' magnitudes: 1e-4 relative, with an
absolute floor of 1e-5 of a tensor's largest entry where entries cancel."""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark import loop, traffic
from benchmark.reference import ldm as ref_ldm
from benchmark.reference import maisi, nets
from medical_image_generation_tpu_torch.models.blocks import AttentionBlock
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.ops.attention import dot_product_attention
from medical_image_generation_tpu_torch.training import common
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer
from medical_image_generation_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one intra-op thread a test worker (tests/torch_parity.py)

B, S, C = 2, 16, 4
PARAMS = dict(spatial_dims=3, in_channels=C, out_channels=C, num_res_blocks=2,
              num_channels=[16, 32, 32, 64], attention_levels=[False, False, True, True],
              num_head_channels=[0, 0, 8, 8], norm_num_groups=8,
              strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
              kernel_sizes=[[3, 3, 3]] * 4, paddings=[[1, 1, 1]] * 4,
              include_top_region_index_input=True, include_bottom_region_index_input=True,
              include_spacing_input=True)
CONFIG = {"ddpm_params": PARAMS,
          "ddpm_transformations": {"patch_size": [S] * 3, **dict.fromkeys(
              ["scaling", "rotation", "mirror", "brightness", "contrast", "gamma"], False)},
          "ddpm_learning_rate": 1e-4, "ddpm_weight_decay": 0.0, "grad_clip_max_norm": 1.0,
          "adam_mu_dtype": "float32",
          "time_scheduler_params": {"num_train_timesteps": 1000, "schedule": "scaled_linear_beta",
                                    "beta_start": 0.0015, "beta_end": 0.0195,
                                    "prediction_type": "epsilon"}}
RTOL, ATOL = 1e-4, 1e-5  # float32 summation order (module docstring)


def _close(got, want, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * float(want.detach().abs().max()))


def _weights(params=PARAMS, seed=3):
    ref = maisi.UNet(params)
    return traffic.weights(ref_ldm.named_shapes(ref), nets.norm_weights(ref), seed, 0, "cpu")


def _models(params=PARAMS):
    w = _weights(params)
    ref = ref_ldm.load(maisi.UNet(params), {k: v.clone() for k, v in w.items()})
    prog = DiffusionUNet.from_config(params, dtype=torch.float32, device="cpu")
    prog.load_state_dict(w)
    return prog, ref, w


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, S, S, C), generator=g)
    t = torch.tensor([3, 900])
    cond = {"top_region_index_tensor": F.one_hot(torch.tensor([0, 1]), 4).float(),
            "bottom_region_index_tensor": F.one_hot(torch.tensor([2, 1]), 4).float(),
            "spacing_tensor": torch.tensor([[0.7, 0.7, 2.5], [1.2, 1.2, 0.8]])}
    return x, t, cond


def test_maisi_unet_forward_matches_the_reference():
    prog, ref, _ = _models()
    x, t, cond = _inputs()
    with torch.no_grad():
        got = prog(x, t, **cond)
        want = ref(x.movedim(-1, 1), t, **cond).movedim(1, -1)
    _close(got, want)
    # the embeddings reach the output: other regions give another prediction
    other = dict(cond, top_region_index_tensor=cond["bottom_region_index_tensor"])
    with torch.no_grad():
        assert (prog(x, t, **other) - got).abs().max() > 1e-3 * got.abs().max()


def test_maisi_loss_and_every_gradient_match_the_reference():
    prog, ref, _ = _models()
    x, t, cond = _inputs(1)
    target = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    loss_p = torch.mean((prog(x, t, **cond) - target) ** 2)
    loss_r = torch.mean((ref(x.movedim(-1, 1), t, **cond) - target.movedim(-1, 1)) ** 2)
    loss_p.backward()
    loss_r.backward()
    _close(loss_p.detach(), loss_r.detach())
    grads_r = dict(ref.named_parameters())
    names = [n for n, _ in prog.named_parameters()]
    assert names == list(grads_r)
    for name, p in prog.named_parameters():
        _close(p.grad, grads_r[name].grad)
    assert any("spacing_layer" in n for n in names)


def test_precomputed_latent_train_step_matches_the_reference_follow():
    """One ``LDMTrainer.train_step`` on precomputed latents against the
    reference's ``follow``: the scale, the loss, the clip's norm, each leaf's
    first gradient as AdamW received it (from its second moment) and each
    leaf's change."""
    w = _weights()
    tr = LDMTrainer.from_config(CONFIG, None, {k: v.clone() for k, v in w.items()},
                                device="cpu", dtype=torch.float32,
                                latent_space_type="precomputed")
    assert tr.vae is None and not tr.augments
    g = torch.Generator().manual_seed(5)
    batch = 0.6 * torch.randn((B, S, S, S, C), generator=g) + 0.1
    scale, shape = tr.probe_latent(batch)
    assert shape == (B, S, S, S, C)
    draw = {"t": torch.tensor([17, 640]), "noise": torch.randn((B, S, S, S, C), generator=g),
            "cond": {k[:-len("_tensor")]: v for k, v in _inputs()[2].items()}}
    loss = tr.train_step(batch, draws=common.TrainDraws(None, None, draw["t"], draw["noise"]),
                         cond={f"{k}_tensor": v for k, v in draw["cond"].items()})
    ref = maisi.follow(CONFIG, {"batch": B}, w, [batch.numpy()], [draw], "cpu", steps=1)
    assert scale == pytest.approx(ref["scale"], rel=1e-6)
    assert float(loss) == pytest.approx(ref["losses"][0], rel=RTOL)
    assert float(tr.opt.last_norm) == pytest.approx(ref["grad_norm"], rel=RTOL)
    assert tr.param_names == ref["names"]
    for name, nu, g0 in zip(tr.param_names, tr.opt.nu, ref["grad0"]):
        _close((nu / (1 - ref_ldm.B2)).sqrt(), g0.abs() * ref["grad_scale"])
    # Adam's first step moves an entry by lr g / (|g| + eps): where g is
    # within a few ulps of eps (1e-8) round-off alone moves it by up to the
    # whole lr, so entries the benchmark leaves out of the change are left out;
    # a change is a difference of two float32 parameters, so it is exact only
    # to an ulp of the parameter (2^-23 of its magnitude) on each side
    for name, p, d, k in zip(tr.param_names, tr.params, ref["delta"], loop.kept(ref["grad0"])):
        torch.testing.assert_close((p.detach() - w[name])[k], d[k], rtol=RTOL,
                                   atol=2 ** -22 * float(w[name].abs().max()))


def test_precomputed_latent_val_step_takes_the_conditioning():
    """``val_step`` on precomputed latents passes the conditioning to the
    U-Net as ``train_step`` does: before any step its loss is the reference's
    first loss from the same weights and draws; without it the U-Net refuses."""
    w = _weights()
    tr = LDMTrainer.from_config(CONFIG, None, {k: v.clone() for k, v in w.items()},
                                device="cpu", dtype=torch.float32,
                                latent_space_type="precomputed")
    g = torch.Generator().manual_seed(7)
    batch = 0.8 * torch.randn((B, S, S, S, C), generator=g) - 0.2
    tr.probe_latent(batch)
    draw = {"t": torch.tensor([250, 3]), "noise": torch.randn((B, S, S, S, C), generator=g),
            "cond": {k[:-len("_tensor")]: v for k, v in _inputs()[2].items()}}
    draws = common.TrainDraws(None, None, draw["t"], draw["noise"])
    with torch.no_grad():
        loss = tr.val_step(batch, draws=draws,
                           cond={f"{k}_tensor": v for k, v in draw["cond"].items()})
        with pytest.raises(ValueError, match="embedding inputs"):
            tr.val_step(batch, draws=draws)
    ref = maisi.follow(CONFIG, {"batch": B}, w, [batch.numpy()], [draw], "cpu", steps=1)
    assert float(loss) == pytest.approx(ref["losses"][0], rel=RTOL)


def test_maisi_flags_off_is_the_unet_without_them():
    """With the three ``include_*`` keys false the U-Net is the planner's U-Net,
    parameter for parameter and bit for bit; present, they only add the three
    MLPs (registered last) and widen each ResBlock's projection."""
    plain = {k: v for k, v in PARAMS.items() if not k.startswith("include_")}
    off = dict(plain, **{k: False for k in PARAMS if k.startswith("include_")})
    torch.manual_seed(0)
    a = DiffusionUNet.from_config(plain, dtype=torch.float32, device="cpu")
    torch.manual_seed(0)
    b = DiffusionUNet.from_config(off, dtype=torch.float32, device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.embeddings == () and a.ResBlock_0.Dense_0.in_features == 4 * 16
    x, t, _ = _inputs()
    with torch.no_grad():
        assert torch.equal(a(x, t), b(x, t))
    on = DiffusionUNet.from_config(PARAMS, dtype=torch.float32, device="cpu")
    names_on = [n for n, _ in on.named_parameters()]
    assert names_on[:len(sa)] == list(sa)
    assert {n.split(".")[0] for n in names_on[len(sa):]} == {
        "top_region_index_layer", "bottom_region_index_layer", "spacing_layer"}
    assert on.ResBlock_0.Dense_0.in_features == 4 * 4 * 16


def test_maisi_unet_refuses_missing_or_unknown_embedding_inputs():
    prog, _, _ = _models()
    x, t, cond = _inputs()
    with pytest.raises(ValueError, match="embedding inputs"):
        prog(x, t)
    plain = DiffusionUNet.from_config(
        {k: v for k, v in PARAMS.items() if not k.startswith("include_")},
        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="embedding inputs"):
        plain(x, t, **cond)


@pytest.mark.parametrize("H", [8, 16])
def test_flash_plain_path_at_head_dim_32_matches_the_reference_attention(H):
    """The port's attention entry (the flash plain path on the CPU) at MAISI's
    head width against the reference's attention in checkpointed row blocks,
    forward and gradients."""
    g = torch.Generator().manual_seed(H)
    q, k, v = (torch.randn((2, 96, H, 32), generator=g, requires_grad=True) for _ in range(3))
    do = torch.randn((2, 96, H, 32), generator=g)
    out = dot_product_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    qr, kr, vr = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    ref = maisi.chunked_attention(qr, kr, vr, score_elems=2 * H * 96 * 20)  # 5 row blocks
    grads_r = torch.autograd.grad(ref, (qr, kr, vr), do.transpose(1, 2))
    _close(out, ref.transpose(1, 2))
    for got, want in zip(grads, grads_r):
        _close(got, want.transpose(1, 2))


def test_precomputed_mode_refuses_augmentation_and_sampling():
    cfg = copy.deepcopy(CONFIG)
    cfg["ddpm_transformations"]["mirror"] = True
    with pytest.raises(ValueError, match="mirror"):
        LDMTrainer.from_config(cfg, None, device="cpu", dtype=torch.float32,
                               latent_space_type="precomputed")
    tr = LDMTrainer.from_config(CONFIG, None, device="cpu", dtype=torch.float32,
                                latent_space_type="precomputed")
    tr.probe_latent(torch.randn((B, S, S, S, C)))
    with pytest.raises(NotImplementedError, match="precomputed"):
        tr.sample_images(1)


def test_attention_blocks_are_spans_under_the_profiler():
    prog, _, _ = _models()
    x, t, cond = _inputs()
    profiling.reset()
    with torch.no_grad():
        prog(x, t, **cond)
    assert profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        prog(x, t, **cond)
    recs = profiling.records()
    profiling.reset()
    n = sum(isinstance(m, AttentionBlock) for m in prog.modules())
    assert n == 11 and [r.name for r in recs] == ["medimgen.attention"] * n
