"""PyTorch port, memory planning and rematerialisation: the batch-size
ladder of ``planning/memory.py`` against the JAX package's, both fed one
stubbed estimator (the rungs of ``tests/test_memory_and_entry.py``); the
budget and the trial estimator raising on the CPU; the KL-VAE's and the
VQ-VAE's ``use_checkpointing`` / ``remat_policy`` (an unknown policy
raises, parameter names do not change, "acts" recomputes no convolution in
the backward, the GroupNorm forward launches a rematerialised step makes);
one AE train step with the adversarial loss under no remat / "acts" /
"full" in fp32: losses and generator / discriminator gradients equal to no
remat (rtol 1e-5 of each element and of the tensor's largest), and losses
equal to the JAX step under the same policy from the same weights and
draws (rtol 1e-4, the tolerance of ``tests/test_torch_train_ae.py``); and
one tiny epoch of
``medimgen_torch_train_autoencoder`` with ``use_checkpointing: true``
under each policy, for ``-l vae`` and ``-l vq``, equal to the epoch
without it. The diffusion U-Net's ``use_checkpointing`` (the JAX
``nn.remat(ResBlock)``): ``from_config`` reads it, every ResBlock and no
attention block runs under ``checkpoint``, the outputs and gradients equal
no remat, and autograd keeps fewer bytes across the forward."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from medical_image_generation_tpu.planning import memory as jmemory
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.models import autoencoder_kl
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.blocks import AttentionBlock, GroupNorm, ResBlock
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.models.vqvae import VQVAE
from medical_image_generation_tpu_torch.ops import groupnorm as tgn
from medical_image_generation_tpu_torch.planning import memory as tmemory
from medical_image_generation_tpu_torch.planning.planner import flagship_configs
from medical_image_generation_tpu_torch.training import train_autoencoder
from medical_image_generation_tpu_torch.training.train_autoencoder import AEDraws
from test_torch_augment import jax_draws
from test_torch_cli_ae import ae_env  # noqa: F401  (fixture)
from test_torch_train_ae import ae_config, jax_and_port

RUNGS = [(False, "acts"), (True, "acts"), (True, "full")]


# ----------------------------------------------------------------- the ladder


def _fake_estimate(no_remat=100, acts=80, full=60):
    """Bytes a step: per-sample cost by rung, times the batch."""
    def fake(config, bs, use_checkpointing=False, remat_policy="acts", **_):
        if not use_checkpointing:
            per_sample = no_remat
        else:
            per_sample = acts if remat_policy == "acts" else full
        return bs * per_sample
    return fake


@pytest.mark.parametrize("model_type,init,budget,want", [
    ("2d", 8, 10**12, (8, 1, False, "acts")),   # fits as planned
    ("3d", 8, 8 * 80, (8, 1, True, "acts")),    # remat before halving, "acts" first
    ("3d", 8, 8 * 70, (8, 1, True, "full")),    # "acts" too big, "full" fits
    ("2d", 24, 8 * 60, (6, 2, True, "full")),   # halves toward the 2D minimum
    ("3d", 2, 1 * 60, (1, 2, True, "full")),    # halves once to the 3D minimum
    ("3d", 1, 10, (1, 2, True, "full")),        # already at the minimum: warns
    ("2d", 24, 12 * 60, (12, 2, True, "full")),  # the first halving fits
])
def test_ladder_equals_jax(monkeypatch, capsys, model_type, init, budget, want):
    """The same stubbed estimator through both ladders gives the same plan
    (the cases of tests/test_memory_and_entry.py:105-160, and two more)."""
    fake = _fake_estimate()
    monkeypatch.setattr(jmemory, "estimate_ae_step_memory", fake)
    monkeypatch.setattr(tmemory, "estimate_ae_step_memory", fake)
    got = tmemory.auto_select_hyperparams({}, model_type, init_batch_size=init,
                                          budget_bytes=budget)
    ref = jmemory.auto_select_hyperparams({}, model_type, init_batch_size=init,
                                          budget_bytes=budget)
    assert tuple(got) == tuple(ref) == want
    warned = "may not fit" in capsys.readouterr().out
    assert warned == (init == 1)


def test_ladder_takes_out_of_memory_as_does_not_fit(monkeypatch):
    """An estimate of inf (the trial ran out of memory) moves the ladder on
    like any estimate over the budget."""
    def fake(config, bs, use_checkpointing=False, remat_policy="acts", **_):
        return math.inf if not use_checkpointing else 10
    monkeypatch.setattr(tmemory, "estimate_ae_step_memory", fake)
    plan = tmemory.auto_select_hyperparams({}, "3d", init_batch_size=2, budget_bytes=100)
    assert plan == tmemory.MemoryPlan(2, 1, True, "acts")


@pytest.mark.parametrize("device,err", [("cpu", ValueError), ("cuda", RuntimeError)])
def test_budget_and_estimator_raise_without_the_card(monkeypatch, device, err):
    """On the CPU the probe has nothing to measure: the budget, the trial
    and the ladder without a given budget raise (ValueError for an explicit
    CPU device, RuntimeError when CUDA is asked for and absent)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ae_config()
    with pytest.raises(err):
        tmemory.device_memory_budget(device)
    with pytest.raises(err):
        tmemory.estimate_ae_step_memory(cfg, 2, device=device)
    with pytest.raises(err):
        tmemory.auto_select_hyperparams(cfg, "3d", init_batch_size=2, device=device)
    assert tmemory.SAFETY_FRACTION == jmemory.SAFETY_FRACTION


# ------------------------------------------------------------ the models


@pytest.mark.parametrize("cls", [AutoencoderKL, VQVAE])
def test_unknown_remat_policy_raises_and_names_stay(cls):
    vae_p, _, _ = flagship_configs(tiny=True)
    with pytest.raises(ValueError, match="remat_policy"):
        cls.from_config(dict(vae_p, use_checkpointing=True, remat_policy="bogus"),
                        device="cpu")
    plain = cls.from_config(vae_p, device="cpu")
    for policy in ("acts", "full"):
        m = cls.from_config(dict(vae_p, use_checkpointing=True, remat_policy=policy),
                            device="cpu")
        assert m.encoder.remat == m.decoder.remat == policy
        assert list(m.state_dict()) == list(plain.state_dict())
    assert plain.encoder.remat is None and plain.decoder.remat is None


class _CountConvolutions(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _count_gn(monkeypatch):
    """Count calls of the GroupNorm forward's two wrappers (their plain
    versions run on the CPU, where the launch counters stay at 0)."""
    seen = {"stats_fold": 0, "affine_act": 0}
    for name in seen:
        orig = getattr(tgn, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tgn, name, wrapped)
    return seen


@pytest.mark.parametrize("rung", RUNGS, ids=["none", "acts", "full"])
def test_remat_recomputes_what_the_policy_says(monkeypatch, rung):
    """fp32 on the CPU: the same gradients as without remat, bit for bit;
    the backward recomputes no convolution under "acts" and some under
    "full"; and each rematerialised ResBlock runs its two GroupNorm
    forwards a second time in the backward (the count chip_smoke.py
    predicts for the kernels)."""
    remat, policy = rung
    vae_p, _, _ = flagship_configs(tiny=True)
    torch.manual_seed(0)
    base = AutoencoderKL.from_config(vae_p, dtype=torch.float32, device="cpu")
    m = AutoencoderKL.from_config(dict(vae_p, use_checkpointing=remat, remat_policy=policy),
                                  dtype=torch.float32, device="cpu")
    m.load_state_dict(base.state_dict())
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((2, 32, 32, 32, 1), generator=gen)
    eps = torch.randn((2, 16, 16, 16, vae_p["latent_channels"]), generator=gen)

    def grads(model, count=None):
        rec, mu, sig = model(x, eps)
        loss = (rec - x).abs().mean() + (mu.square() + sig.square()).mean()
        with count or _CountConvolutions() as c:
            return loss, torch.autograd.grad(loss, list(model.parameters())), c.n

    loss0, g0, _ = grads(base)
    seen = _count_gn(monkeypatch)
    loss, g, n_conv = grads(m, _CountConvolutions())
    assert loss.item() == loss0.item()
    assert all(torch.equal(a, b) for a, b in zip(g, g0))
    resblock_gn = sum(isinstance(c, GroupNorm) for blk in m.modules()
                      if isinstance(blk, ResBlock) for c in blk.modules())
    all_gn = sum(isinstance(c, GroupNorm) for c in m.modules())
    want = all_gn + (resblock_gn if remat else 0)
    assert seen == {"stats_fold": want, "affine_act": want}
    if policy == "full" and remat:
        assert n_conv > 0
    else:
        assert n_conv == 0


def test_frozen_uses_skip_remat(monkeypatch):
    """Under no_grad (the LDM trainer's and the sampler's frozen
    autoencoder) no checkpoint is taken."""
    vae_p, _, _ = flagship_configs(tiny=True)
    m = AutoencoderKL.from_config(dict(vae_p, use_checkpointing=True, remat_policy="full"),
                                  dtype=torch.float32, device="cpu")
    calls = []
    monkeypatch.setattr(autoencoder_kl.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or pytest.fail("checkpointed"))
    with torch.no_grad():
        m.reconstruct(torch.rand((1, 32, 32, 32, 1)))
    assert not calls


# ------------------------------------------------ the AE step, remat vs not


def _capture(opt, store, key):
    orig = opt.step

    def step(grads):
        store[key] = [None if g is None else g.detach().clone() for g in grads]
        return orig(grads)
    opt.step = step


@pytest.mark.parametrize("latent", ["vae", "vq"])
def test_ae_step_under_each_policy_matches_no_remat_and_jax(latent):
    """One AE train step with the adversarial loss from the same weights and
    draws under no remat, "acts" and "full": the port's five losses and its
    generator and discriminator gradients equal no remat's (rtol 1e-5, and
    1e-5 of each tensor's largest element: the VQ codebook's gradient is a
    multithreaded scatter-add on the CPU, whose order varies from run to
    run), and its losses equal the JAX step's under the same policy (rtol
    1e-4)."""
    seed = 131 if latent == "vae" else 141
    out = {}
    for remat, policy in RUNGS:
        cfg = ae_config()
        cfg["vae_params"] = dict(cfg["vae_params"], use_checkpointing=remat,
                                 remat_policy=policy)
        tr, g_state, d_state, port = jax_and_port(cfg, latent, seed=seed)
        assert port.model.encoder.remat == (policy if remat else None)
        # flax lists a remat module's params in another order, so the seeded
        # weights are drawn once, without remat, and loaded into every rung
        if not remat:
            g0, sd0 = g_state.params, copy.deepcopy(port.model.state_dict())
        g_state = g_state.replace(params=g0)
        port.model.load_state_dict(sd0)
        initial = compute_initial_patch_size(cfg["ae_transformations"])
        x = np.random.default_rng(seed + 1).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
        rng = jax.random.PRNGKey(seed + 2)
        aug_rng, samp_rng, _ = jax.random.split(rng, 3)
        eps = None
        if latent == "vae":
            eps = torch.from_numpy(np.array(jax.random.normal(samp_rng, (2, 16, 16, 16, 4),
                                                              jnp.float32)))
        store = {}
        _capture(port.g_opt, store, "g")
        _capture(port.d_opt, store, "d")
        m = port.train_step(torch.from_numpy(x), True,
                            draws=AEDraws(jax_draws(aug_rng, 2, 1, tr.aug_cfg), eps))
        _, _, jm = tr._make_train_step(True)(g_state, d_state, jnp.asarray(x), rng)
        for k in train_autoencoder.METRICS:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-9,
                                       err_msg=f"{policy} {k}")
        out[(remat, policy)] = ({k: v.item() for k, v in m.items()}, store)
    base_m, base_g = out[RUNGS[0]]
    for rung in RUNGS[1:]:
        got_m, got_g = out[rung]
        for k, v in base_m.items():
            assert got_m[k] == pytest.approx(v, rel=1e-5), (rung, k)
        for key in ("g", "d"):
            for a, b in zip(got_g[key], base_g[key]):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                               atol=1e-5 * float(b.abs().max()),
                                               err_msg=f"{rung} {key}")


# ------------------------------------------------------- the stage-1 CLI


@pytest.mark.parametrize("latent", ["vae", "vq"])
def test_ae_cli_trains_with_use_checkpointing(ae_env, monkeypatch, tmp_path, latent):
    """One tiny epoch (3 + 2 steps, the adversarial loss on) of
    medimgen_torch_train_autoencoder with use_checkpointing: true under each
    policy: the same losses and final parameters as the epoch without it."""
    runs = {}
    for remat, policy in RUNGS:
        monkeypatch.setenv("medimgen_results", str(tmp_path / f"res_{int(remat)}{policy}"))
        tr = train_autoencoder.run_cli(ae_env + [
            "-l", latent, "--set", "n_epochs=1", "--set", "autoencoder_warm_up_epochs=0",
            "--set", f"vae_params.use_checkpointing={str(remat).lower()}",
            "--set", f"vae_params.remat_policy={policy}"])
        assert tr.model.encoder.remat == (policy if remat else None)
        runs[(remat, policy)] = (copy.deepcopy(tr.loss_dict),
                                 [p.detach().clone() for p in tr.g_params])
    base_l, base_p = runs[RUNGS[0]]
    assert base_l["gen_adv"][0] > 0
    for rung in RUNGS[1:]:
        got_l, got_p = runs[rung]
        for k, v in base_l.items():
            np.testing.assert_allclose(got_l[k], v, rtol=1e-5, err_msg=f"{rung} {k}")
        for a, b in zip(got_p, base_p):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- the U-Net's remat


def _unet_pair():
    """The tiny 3D U-Net without and with use_checkpointing, same weights
    (every layer seeded, the zero-initialised output conv too)."""
    _, ddpm_p, _ = flagship_configs(tiny=True)
    torch.manual_seed(0)
    base = DiffusionUNet.from_config(ddpm_p, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for p in base.parameters():
            p.copy_(torch.randn(p.shape) / math.sqrt(p[0].numel() if p.dim() > 1 else 50.0))
    m = DiffusionUNet.from_config(dict(ddpm_p, use_checkpointing=True), dtype=torch.float32,
                                  device="cpu")
    m.load_state_dict(base.state_dict())
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, 16, 16, ddpm_p["in_channels"]), generator=gen)
    return base, m, x, torch.tensor([5, 901])


def _recording_checkpoint(monkeypatch):
    """Patch the checkpoint ``remat_call`` takes: record each checkpointed
    block and its inputs, then checkpoint as before."""
    seen = []
    orig = autoencoder_kl.checkpoint.checkpoint

    def rec(fn, *args, **kw):
        seen.append((fn, args))
        return orig(fn, *args, **kw)

    monkeypatch.setattr(autoencoder_kl.checkpoint, "checkpoint", rec)
    return seen


def test_unet_use_checkpointing_reaches_every_resblock(monkeypatch):
    """``from_config`` reads ``use_checkpointing``; with it every ResBlock
    (and no attention block) runs under a non-reentrant checkpoint with no
    policy, each rematerialised ResBlock runs its two GroupNorm forwards
    again in the backward, the state_dict keys do not change, and under
    ``no_grad`` nothing is checkpointed."""
    base, m, x, t = _unet_pair()
    assert base.remat is None and m.remat == "full"
    assert list(m.state_dict()) == list(base.state_dict())
    seen = _recording_checkpoint(monkeypatch)
    with torch.no_grad():
        m(x, t)
    assert seen == []
    resblocks = [b for b in m.modules() if isinstance(b, ResBlock)]
    n_gn = sum(isinstance(c, GroupNorm) for c in m.modules())
    counts = _count_gn(monkeypatch)
    out = m(x, t)
    assert [fn for fn, _ in seen] == resblocks
    assert not any(isinstance(fn, AttentionBlock) for fn, _ in seen)
    assert counts == {"stats_fold": n_gn, "affine_act": n_gn}
    out.square().mean().backward()
    assert counts == {"stats_fold": n_gn + 2 * len(resblocks),
                      "affine_act": n_gn + 2 * len(resblocks)}
    del seen[:]
    base(x, t)  # under autograd, where remat_call would checkpoint
    assert seen == []


def test_unet_remat_matches_no_remat_and_keeps_fewer_bytes(monkeypatch):
    """fp32 on the CPU: outputs and every parameter's gradient equal without
    and with remat (rtol 1e-5 of each element and of the tensor's largest),
    and the bytes autograd keeps across the forward (tensors packed for the
    backward outside the checkpoints, plus the checkpointed blocks' inputs,
    each storage once) are fewer with it."""
    base, m, x, t = _unet_pair()
    seen = _recording_checkpoint(monkeypatch)

    def run(model):
        kept = {}

        def pack(tensor):
            kept[(tensor.untyped_storage().data_ptr(), tensor.untyped_storage().nbytes())] = 1
            return tensor

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
            out = model(x, t)
        for _, args in seen:
            for a in args:
                if isinstance(a, torch.Tensor):
                    kept[(a.untyped_storage().data_ptr(), a.untyped_storage().nbytes())] = 1
        loss = out.square().mean()
        return out, torch.autograd.grad(loss, list(model.parameters())), sum(n for _, n in kept)

    out0, g0, kept0 = run(base)
    out1, g1, kept1 = run(m)
    np.testing.assert_allclose(out1.detach().numpy(), out0.detach().numpy(), rtol=1e-5,
                               atol=1e-5 * float(out0.detach().abs().max()))
    for (name, _), a, b in zip(base.named_parameters(), g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()) + 1e-30, err_msg=name)
    assert len(seen) == sum(isinstance(b, ResBlock) for b in m.modules())
    assert kept1 < 0.8 * kept0, (kept1, kept0)
