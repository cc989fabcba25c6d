"""PyTorch port, parallelism: ``parallel/mesh.py``, ``parallel/sharding.py``,
the loader's row slices and the trainers on a (data, model) mesh, against
the JAX package's ``parallel/`` on its 8-device CPU mesh.

The mesh arithmetic, the sharding rule and the row-sliced loader run in
this process. The multi-rank checks run once, in one group of 2 gloo ranks
spawned for the module (``torch_dist_ranks.parallel_checks``): a
data-parallel tiny LDM step and AE step (adversarial loss on) against the
JAX step on a data = 2 mesh and the port's one-process step at the global
batch; a data = 1, model = 2 tiny DDPM step, with ring attention inside its
sharded attention blocks, against the replicated one, with the clipped
gradient's norm (``test_tp_loss_matches_replicated``,
``tests/test_parallel.py:197``); a checkpoint the 2 model-parallel ranks
write, loaded in one process. fp32."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from medical_image_generation_tpu.parallel import mesh as jmesh
from medical_image_generation_tpu.parallel import sharding as jsharding
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.data import loader as tloader
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.parallel import mesh as tmesh
from medical_image_generation_tpu_torch.parallel import sharding as tsharding
from medical_image_generation_tpu_torch.training import checkpoints as tckpt
from medical_image_generation_tpu_torch.training import common as tcommon
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training.train_autoencoder import AEDraws
from medical_image_generation_tpu_torch.training.train_ddpm import DDPMTrainer
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer, TrainDraws
from test_torch_augment import jax_draws
from test_torch_ddpm import _config as ddpm_config
from test_torch_train_ae import ae_config, check_first_adam_update, check_mu, jax_and_port, jax_mu
from test_torch_training import LR, _config, _jax_trainer
from torch_dist_ranks import Ranks, parallel_checks
from torch_parity import nd, tiny_unet_pair, tiny_vae_pair

# ------------------------------------------------------------- mesh arithmetic


@pytest.mark.parametrize("n,model", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (2, 1), (1, 1)])
def test_mesh_layout_matches_jax_get_mesh(n, model):
    """The (data, model) grid: JAX's device ids of ``get_mesh(n, model)``."""
    jm = jmesh.get_mesh(n_devices=n, model_parallel=model)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(tmesh.mesh_layout(n, model), ids - ids.min())
    assert dict(jm.shape) == {"data": n // model, "model": model}


@pytest.mark.parametrize("n,model", [(8, 3), (6, 4), (2, 4)])
def test_mesh_layout_refuses_what_jax_refuses(n, model):
    with pytest.raises(ValueError) as jerr:
        jmesh.get_mesh(n_devices=n, model_parallel=model)
    with pytest.raises(ValueError) as terr:
        tmesh.mesh_layout(n, model)
    assert str(terr.value) == str(jerr.value)


def test_get_mesh_in_one_process():
    """No process group: a (1, 1) mesh, no groups, every row built here;
    asking for more devices than the world has raises JAX's message."""
    mesh = tmesh.get_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == (0, 0)
    assert mesh.data_group is None and mesh.model_group is None and mesh.is_writer
    assert tmesh.data_axis_rows(mesh, 4) == (0, 4)
    with pytest.raises(ValueError) as jerr:
        jmesh.get_mesh(n_devices=16)
    with pytest.raises(ValueError) as terr:
        tmesh.get_mesh(n_devices=2)
    head = "devices are visible; provision more"
    assert head in str(jerr.value) and head in str(terr.value)
    with tmesh.get_mesh(model_parallel=1) as m:
        assert tmesh.active_mesh() is m
    assert tmesh.active_mesh() is None


@pytest.mark.parametrize("grid,proc", [
    ([[0, 0], [0, 0], [1, 1], [1, 1]], 0), ([[0, 0], [0, 0], [1, 1], [1, 1]], 1),
    ([[0, 0, 1, 1], [2, 2, 3, 3]], 1), ([[0, 0, 1, 1], [2, 2, 3, 3]], 3),
    ([[0, 0, 0, 0, 1, 1, 1, 1]], 1), ([[0, 1], [2, 3], [4, 5], [6, 7]], 5)])
def test_owned_data_coords_matches_jax(grid, proc):
    g = np.array(grid)
    assert tmesh._owned_data_coords(g, proc) == jmesh._owned_data_coords(g, proc)


@pytest.mark.parametrize("b,n_data", [(2, 8), (8, 8), (5, 4), (1, 3), (6, 1)])
def test_pad_batch_to_devices_matches_jax(b, n_data):
    mesh = types.SimpleNamespace(shape={"data": n_data, "model": 1})
    batch = {"image": nd((b, 4, 3), b), "class": np.arange(b, dtype=np.int32)}
    got, want = tmesh.pad_batch_to_devices(batch, mesh), jmesh.pad_batch_to_devices(batch, mesh)
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("model", [1, 2, 4])
def test_data_axis_rows_of_every_rank(model):
    """Rows [d * rpc, (d + 1) * rpc) for data coordinate d, whatever the
    model axis (co-owners of a row build the same rows); the rows of the
    data axis tile the global batch; an indivisible batch raises."""
    grid = tmesh.mesh_layout(8, model)
    rows = []
    for rank in range(8):
        mesh = tmesh.Mesh(grid, rank, torch.device("cpu"))
        d = mesh.coords[0]
        rpc = 16 // grid.shape[0]
        assert tmesh.data_axis_rows(mesh, 16) == (d * rpc, rpc)
        rows.append(tmesh.data_axis_rows(mesh, 16))
    assert sorted(set(rows)) == [(i * (16 // grid.shape[0]), 16 // grid.shape[0])
                                 for i in range(grid.shape[0])]
    if grid.shape[0] > 1:
        with pytest.raises(ValueError, match="not a multiple of the data axis"):
            tmesh.data_axis_rows(tmesh.Mesh(grid, 0, torch.device("cpu")), grid.shape[0] + 1)


def test_sharding_rule_matches_jax_on_the_unet_tree():
    """``_spec_for_path`` on every port parameter name of the tiny U-Net
    against JAX's spec of the flax leaf (flax's axis order moved to
    torch's), and ``param_spec``'s replication of leaves that do not divide
    over 4 ranks against ``unet_param_shardings``."""
    jm, params, tm, _, _ = tiny_unet_pair(seed=3)
    jspecs = jsharding.unet_param_shardings(params, jmesh.get_mesh(model_parallel=4))
    flat = jax.tree_util.tree_leaves_with_path(jspecs)
    leaves = {"/".join(str(getattr(p, "key", p)) for p in path): s.spec for path, s in flat}
    shapes = dict(tm.named_parameters())
    seen = 0
    for path, spec in leaves.items():
        names = path.split("/")
        name = ".".join(names[:-1] + ["weight" if names[-1] in ("kernel", "scale") else
                                      names[-1]])
        p = shapes[name]
        spec = tuple(spec) + (None,) * (p.dim() - len(spec))
        # flax kernel (*k, in, out) / (in, out) -> torch (out, in, *k) / (out, in)
        want = (spec[-1], spec[-2], *spec[:-2]) if names[-1] == "kernel" else spec
        assert tsharding.param_spec(name, p.shape, 4) == want, name
        seen += "model" in want
    assert seen > 0 and len(leaves) == len(shapes)


# --------------------------------------------------------------------- loader


class _StubPatchDataset:
    """A 'patch' encodes (pos, idx, rng draw): which global row was built."""

    def __init__(self, n=8, batch_size=4):
        self.ids = [f"p{i}" for i in range(n)]
        self.batch_size = batch_size
        self.class_map = None

    def __len__(self):
        return len(self.ids)

    def sample_patch(self, pos, idx, rng):
        return np.array([pos, idx, rng.integers(0, 1 << 30)], np.int64)


def test_sliced_loaders_build_the_global_rows_of_the_jax_loader():
    """Two ranks' row slices, stacked, are bit for bit the batches of the
    one-process loader and of the JAX loader (same schedule, RNG keyed on
    the global position); a rank's slice is JAX's slice."""
    full = list(tloader.PrefetchLoader(_StubPatchDataset(), 3, num_threads=2, seed=7))
    jfull = list(JPrefetchLoader(_StubPatchDataset(), 3, num_threads=2, seed=7))
    parts = [list(tloader.PrefetchLoader(_StubPatchDataset(), 3, num_threads=2, seed=7,
                                         row_slice=(off, 2))) for off in (0, 2)]
    jpart = list(JPrefetchLoader(_StubPatchDataset(), 3, num_threads=2, seed=7,
                                 row_slice=(1, 2)))
    one = list(tloader.PrefetchLoader(_StubPatchDataset(), 3, num_threads=2, seed=7,
                                      row_slice=(1, 2)))
    for f, jf, a, b, jp, o in zip(full, jfull, *parts, jpart, one):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(np.concatenate([a, b]), f)
        np.testing.assert_array_equal(o, jp)


def test_oversampling_keys_on_the_global_position():
    (batch,) = list(tloader.PrefetchLoader(_StubPatchDataset(), 1, shuffle=False,
                                           num_threads=1, seed=3, row_slice=(2, 2)))
    np.testing.assert_array_equal(batch[:, 0], [2, 3])


def test_multi_rank_loaders_need_the_mesh(monkeypatch, preprocessed_dataset):
    """As JAX's: a run of several ranks without a mesh raises; with one, each
    rank builds its rows of a batch_size x data-axis global batch."""
    root, ds = preprocessed_dataset
    monkeypatch.setattr(tloader.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tloader.dist, "get_world_size", lambda group=None: 2)
    args = ({"num_workers": 1}, ds, "train-val-test", 1, "2d", {"patch_size": [24, 24]})
    with pytest.raises(ValueError, match="needs the mesh"):
        tloader.get_data_loaders(*args, preprocessed_root=root, data_parallel=2)
    mesh = tmesh.Mesh(tmesh.mesh_layout(2), 1, torch.device("cpu"))
    train, val = tloader.get_data_loaders(*args, preprocessed_root=root, data_parallel=2,
                                          mesh=mesh, train_steps=1, val_steps=1)
    assert train.row_slice == val.row_slice == (1, 1)
    assert next(iter(train)).shape[0] == 1


# ------------------------------------------------------------ multi-rank runs


def _ddpm_unet(cfg, seed):
    params, _ = tsample.ddpm_unet_params(cfg)
    unet = DiffusionUNet.from_config(params, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / (p[0].numel() ** 0.5 if p.dim() > 1
                                                           else 10.0))
    return params, unet


def ddpm_inputs():
    """The tiny 3D DDPM case of the model-parallel steps, at an 8^3 patch
    (attention at 64 and 8 tokens): (the ranks' inputs, the replicated
    trainer whose generators drew the global batch's draws)."""
    dcfg = ddpm_config(ema_decay=0.9)
    dcfg["ddpm_transformations"] = dict(dcfg["ddpm_transformations"], patch_size=[8, 8, 8])
    uparams_d, dunet = _ddpm_unet(dcfg, 61)
    rep_tr = DDPMTrainer(dcfg, dunet, device="cpu", seed=62)
    dx = np.random.default_rng(63).uniform(
        0, 1, (2, *compute_initial_patch_size(dcfg["ddpm_transformations"]), 1)).astype(
        np.float32)
    ddraws = rep_tr.make_draws(torch.from_numpy(dx))
    return dict(cfg=dcfg, unet_params=uparams_d, x=dx, draws=ddraws,
                unet={k: v.numpy().copy() for k, v in dunet.state_dict().items()}), rep_tr


def ddpm_reference(ddpm_in, rep_tr):
    """The replicated one-process step at the global batch: its loss, norm,
    params before and after, and Adam's first moments."""
    old = {n: p.detach().clone() for n, p in rep_tr.unet.named_parameters()}
    loss = float(rep_tr.train_step(torch.from_numpy(ddpm_in["x"]), draws=ddpm_in["draws"]))
    return dict(cfg=ddpm_in["cfg"], old=old, loss=loss, norm=float(rep_tr.opt.last_norm),
                tr=rep_tr, mu=dict(zip(rep_tr.param_names, rep_tr.opt.mu)),
                new={n: p.detach().clone() for n, p in rep_tr.unet.named_parameters()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the 2 ranks' results, and the JAX and one-process
    references (computed here while the ranks run), once for the module."""
    tmp = tmp_path_factory.mktemp("ranks")
    (tmp / "ckpt").mkdir()
    # LDM: tiny U-Net and KL-VAE, global batch 2 (a row a rank)
    cfg = _config(ema_decay=None, class_conditioning=None)
    jm, uparams, tm, latent, ddpm_p = tiny_unet_pair(seed=41)
    jvae, vparams, tvae, vae_p = tiny_vae_pair(seed=42)
    x = np.random.default_rng(43).uniform(
        0, 1, (2, *compute_initial_patch_size(cfg["ddpm_transformations"]), 1)).astype(np.float32)
    rng = jax.random.PRNGKey(44)
    tr, jcfg, state = _jax_trainer(cfg, jm, uparams, jvae, vparams, 0.7, None)
    aug_rng, enc_rng, t_rng, n_rng, _ = jax.random.split(rng, 5)
    lat = (2, *latent, ddpm_p["in_channels"])
    draws = TrainDraws(
        augment=jax_draws(aug_rng, 2, 1, jcfg),
        eps=torch.from_numpy(np.array(jax.random.normal(enc_rng, lat, jnp.float32))),
        t=torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 50))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(n_rng, lat, jnp.float32))))
    ldm_in = dict(cfg=cfg, ddpm_params=ddpm_p, vae_params=vae_p, scale=0.7, x=x, draws=draws,
                  unet={k: v.numpy() for k, v in tm.state_dict().items()},
                  vae={k: v.numpy() for k, v in tvae.state_dict().items()})

    # AE with the adversarial loss: tiny KL-VAE, global batch 2
    acfg = ae_config()
    atr, g_state, d_state, aport = jax_and_port(acfg, "vae", seed=51)
    ax = np.random.default_rng(52).uniform(
        0, 1, (2, *compute_initial_patch_size(acfg["ae_transformations"]), 1)).astype(np.float32)
    arng = jax.random.PRNGKey(53)
    a_aug, a_samp, _ = jax.random.split(arng, 3)
    adraws = AEDraws(jax_draws(a_aug, 2, 1, atr.aug_cfg), torch.from_numpy(
        np.array(jax.random.normal(a_samp, (2, 16, 16, 16, 4), jnp.float32))))
    ae_in = dict(cfg=acfg, x=ax, draws=adraws,
                 g={k: v.numpy() for k, v in aport.model.state_dict().items()},
                 d={k: v.numpy() for k, v in aport.discriminator.state_dict().items()},
                 perc={k: v.numpy() for k, v in aport.perceptual.module.state_dict().items()})

    # DDPM at an 8^3 patch for the model-parallel step
    ddpm_in, rep_tr = ddpm_inputs()

    out = {"ckpt_dir": str(tmp / "ckpt")}
    ranks = Ranks(parallel_checks, 2, tmp, dict(ldm=ldm_in, ae=ae_in, ddpm=ddpm_in),
                  out["ckpt_dir"])

    jm2 = jmesh.get_mesh(n_devices=2)
    rep, bsh = jmesh.replicated_sharding(jm2), jmesh.batch_sharding(jm2)
    state, jloss = tr._make_train_step()(jax.device_put(state, rep),
                                         jax.device_put(vparams, rep),
                                         jax.device_put(jnp.asarray(x), bsh), rng)
    one = LDMTrainer(cfg, tm, tvae, device="cpu")
    one.scale_factor = 0.7
    out["ldm"] = dict(
        old=convert.unet_from_flax(uparams),
        jax=(float(jloss), convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                              state.params))),
        one=(float(one.train_step(torch.from_numpy(x), draws=draws)),
             {n: p.detach().clone() for n, p in one.unet.named_parameters()},
             dict(zip(one.param_names, [m.float() for m in one.opt.mu]))))

    g_old = {n: p.detach().clone() for n, p in aport.model.named_parameters()}
    d_old = {n: p.detach().clone() for n, p in aport.discriminator.named_parameters()}
    g_state, d_state, jmet = atr._make_train_step(True)(
        jax.device_put(g_state, rep), jax.device_put(d_state, rep),
        jax.device_put(jnp.asarray(ax), bsh), arng)
    amet = aport.train_step(torch.from_numpy(ax), True, draws=adraws)
    out["ae"] = dict(g_old=g_old, d_old=d_old, jax_metrics={k: float(v) for k, v in jmet.items()},
                     jax_g=convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                             g_state.params)),
                     jax_d=convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                             d_state.params)),
                     jax_g_mu=jax_mu(g_state), jax_d_mu=jax_mu(d_state),
                     one_metrics={k: float(v) for k, v in amet.items()},
                     one_g={n: p.detach().clone() for n, p in aport.model.named_parameters()},
                     one_d={n: p.detach().clone()
                            for n, p in aport.discriminator.named_parameters()},
                     one_g_mu={n: m.clone() for n, m in zip(aport.g_names, aport.g_opt.mu)},
                     one_d_mu={n: m.clone() for n, m in zip(aport.d_names, aport.d_opt.mu)},
                     names=(aport.g_names, aport.d_names))

    out["ddpm"] = ddpm_reference(ddpm_in, rep_tr)
    out["ranks"] = ranks.join()
    return out


def _adam_step_close(old, new, ref, names, lr, wd, what, max_off=0.01):
    """The first AdamW update is -lr * (g / (|g| + eps) + wd * p): u = (p_old
    - p_new) / lr - wd * p_old is about sign(g). Where the reference |u| >
    0.99 the two agree to 1e-3; |u| <= 1 everywhere; at most ``max_off`` of
    the elements (|g| near eps, where the order of a sum decides sign and
    size) are not held (``test_torch_training.py``'s rule). The callers hold
    those elements' gradients through Adam's first moment."""
    n_off = n_all = 0
    for n in names:
        u_r = (old[n] - ref[n]) / lr - wd * old[n]
        u_t = (old[n] - new[n]) / lr - wd * old[n]
        firm = u_r.abs() > 0.99
        np.testing.assert_allclose(u_t[firm].numpy(), u_r[firm].numpy(), rtol=0, atol=1e-3,
                                   err_msg=f"{what} {n}")
        assert bool((u_t.abs() <= 1.0 + 2.0 ** -22 * old[n].abs() / lr + 1e-6).all()), n
        n_off += int((~firm).sum())
        n_all += firm.numel()
    assert n_off <= max_off * n_all, (what, n_off, n_all)


def _bf16_mu_close(got, ref, what):
    """Adam's first moment stored in bf16: each element within one bf16 ulp
    (2^-7 of itself: the two fp32 gradients round to neighbouring values)
    plus 1e-5 of the tensor's largest."""
    for name, r in ref.items():
        mu = torch.as_tensor(got[name]).float()
        r = torch.as_tensor(r).float()
        assert bool(((mu - r).abs() <= 2.0 ** -7 * r.abs() + 1e-5 * r.abs().max()).all()), \
            f"{what} {name}"


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_meshes_on_two_ranks(runs):
    """Rank r: data coordinate r of the (2, 1) mesh and model coordinate r
    of the (1, 2) one; its rows of a global batch of 4 (padded from 3);
    JAX's errors for too many devices and an indivisible model axis."""
    for rank, res in enumerate(runs["ranks"]):
        m = res["mesh"]
        assert m["dp_shape"] == {"data": 2, "model": 1} and m["dp_coords"] == (rank, 0)
        assert m["tp_shape"] == {"data": 1, "model": 2} and m["tp_coords"] == (0, rank)
        assert m["rows"] == (2 * rank, 2) and m["tp_rows"] == (0, 4)
        padded = jmesh.pad_batch_to_devices(np.arange(6.0).reshape(3, 2),
                                            types.SimpleNamespace(shape={"data": 2}))
        np.testing.assert_array_equal(m["put"], padded[2 * rank:2 * rank + 2])
        assert "requested a 4-device mesh but only 2 devices are visible" in m["errors"][0]
        assert m["errors"][1] == "2 devices not divisible by model_parallel=3"


def test_data_parallel_ldm_step_matches_jax_and_one_process(runs):
    """2 ranks of a data = 2 mesh, 2 rows each, from the global batch's
    draws: the loss of the global batch on both ranks; the same params on
    both; against the JAX step on a data = 2 mesh (the rule of
    ``test_torch_training.py``, loss 1e-4) and the port's one-process step
    at the global batch (loss 1e-5: two partial means; Adam's first moment,
    bf16, within one bf16 ulp of each element plus 1e-5 of the largest)."""
    ref, ranks = runs["ldm"], [r["ldm"] for r in runs["ranks"]]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for name in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][name], ranks[1]["params"][name])
    np.testing.assert_allclose(ranks[0]["loss"], ref["jax"][0], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["loss"], ref["one"][0], rtol=1e-5)
    new = _t(ranks[0]["params"])
    names = list(new)
    _adam_step_close(ref["old"], new, ref["jax"][1], names, LR, 1e-2, "vs JAX")
    _adam_step_close(ref["old"], new, ref["one"][1], names, LR, 1e-2, "vs one process")
    _bf16_mu_close(ranks[0]["mu"], ref["one"][2], "mu")


def test_data_parallel_ae_step_matches_jax_and_one_process(runs):
    """The AE step with the adversarial loss, a row a rank of a global batch
    of 2: the five losses on both ranks against the JAX step on a data = 2
    mesh (1e-4, as ``test_torch_train_ae.py``) and the port's one-process
    step (1e-5); both networks' params by the first-Adam rule against both,
    and Adam's first moments (fp32) against JAX as that file holds them."""
    ref = runs["ae"]
    g_names, d_names = ref["names"]
    for res in runs["ranks"]:
        a = res["ae"]
        for k in ("rec", "perc", "reg", "gen_adv", "disc"):
            np.testing.assert_allclose(a["metrics"][k], ref["jax_metrics"][k], rtol=1e-4,
                                       atol=1e-9, err_msg=k)
            np.testing.assert_allclose(a["metrics"][k], ref["one_metrics"][k], rtol=1e-5,
                                       atol=1e-9, err_msg=k)
        g, d = _t(a["g"]), _t(a["d"])
        check_first_adam_update(ref["g_old"], g, ref["jax_g"], ref["jax_g_mu"], g_names,
                                "generator vs JAX")
        check_first_adam_update(ref["d_old"], d, ref["jax_d"], ref["jax_d_mu"], d_names,
                                "discriminator vs JAX")
        _adam_step_close(ref["g_old"], g, ref["one_g"], g_names, 5e-5, 0.0, "generator")
        _adam_step_close(ref["d_old"], d, ref["one_d"], d_names, 5e-5, 0.0, "discriminator")
        g_mu = types.SimpleNamespace(mu=[torch.from_numpy(a["g_mu"][n]) for n in g_names])
        d_mu = types.SimpleNamespace(mu=[torch.from_numpy(a["d_mu"][n]) for n in d_names])
        check_mu(g_mu, g_names, ref["jax_g_mu"], "generator", 1e-3)
        check_mu(d_mu, d_names, ref["jax_d_mu"], "discriminator", 5e-3)
        # against the one-process step: fp32 sums in another order
        check_mu(g_mu, g_names, ref["one_g_mu"], "generator", 1e-4)
        check_mu(d_mu, d_names, ref["one_d_mu"], "discriminator", 1e-4)


def check_model_parallel_step(d, ref, what):
    """A rank's record of a model = 2 tiny DDPM step (``_ddpm_step``)
    against the replicated step: every ResBlock and AttentionBlock sharded
    (half of ConvND_0 / Dense_0 / the GroupNorm_1 it feeds along dim 0, half
    of ConvND_1 / the attention's Dense_1 along dim 1); the ring taken inside
    the sharded attention at the 64-token sites; the loss (1e-5) and the
    gradient norm the clip sees (1e-5: sharded squares summed over the model
    axis, replicated ones once); the gathered params after the step by the
    first-Adam rule, and Adam's first moments."""
    full = {n: p.shape for n, p in ref["tr"].unet.named_parameters()}
    layout = d["layout"]
    blocks = {n.split(".")[0] for n in layout}
    assert {b for b in blocks if b.startswith("AttentionBlock")} and \
        {b for b in blocks if b.startswith("ResBlock")}
    for n, shape in d["local_shapes"].items():
        want = list(full[n])
        if n in layout:
            want[layout[n]] //= 2
        assert list(shape) == want, n
    for n in layout:
        assert n.split(".")[1] in ("ConvND_0", "Dense_0", "GroupNorm_1", "ConvND_1",
                                   "Dense_1"), n
    assert d["ring_calls"] > 0, what
    np.testing.assert_allclose(d["loss"], ref["loss"], rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(d["norm"], ref["norm"], rtol=1e-5, err_msg=what)
    # the tiny net's clipped gradient has many elements near Adam's eps:
    # their updates are held through the first moment instead
    _adam_step_close(ref["old"], _t(d["params"]), ref["new"], list(ref["new"]), 2e-5, 1e-2,
                     what, max_off=1.0)
    _bf16_mu_close(d["mu"], ref["mu"], f"{what} mu")


def test_model_parallel_step_matches_the_replicated_step(runs):
    """data = 1, model = 2, the ring's gate below the tiny U-Net's 64-token
    sites: each rank's step against the replicated one
    (``check_model_parallel_step``), the ring called alike on both ranks."""
    ranks = [res["ddpm"] for res in runs["ranks"]]
    assert ranks[0]["ring_calls"] == ranks[1]["ring_calls"]
    for rank, d in enumerate(ranks):
        check_model_parallel_step(d, runs["ddpm"], f"rank {rank}")


def test_checkpoint_of_two_ranks_loads_in_one_process(runs):
    """The model-parallel ranks' last / best checkpoint (rank 0 wrote it)
    holds whole tensors; a one-process trainer loads it, and its params,
    EMA and Adam moments are the ranks' gathered ones, bit for bit."""
    d = runs["ranks"][0]["ddpm"]
    assert d["saved"] == ["last_model", "best_model"]
    payload = tckpt.load_checkpoint(f"{runs['ckpt_dir']}/best_model.pt")
    _, unet = _ddpm_unet(runs["ddpm"]["cfg"], 99)
    one = DDPMTrainer(runs["ddpm"]["cfg"], unet, device="cpu")
    one.load_payload(payload)
    for n, p in one.unet.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), d["params"][n], err_msg=n)
    for n, m in zip(one.param_names, one.opt.mu):
        np.testing.assert_array_equal(m.float().numpy(), d["mu"][n], err_msg=n)
    assert one.opt.count == 1 and one.step == 1
    assert set(payload["ema_unet"]) == set(one.param_names)
