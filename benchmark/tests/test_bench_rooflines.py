"""The counting functions against hand formulas at tiny sizes, and the trace
reader on a made-up trace."""

import os

import pytest
import torch

from benchmark import harness, rooflines, trace
from benchmark.reference import ldm, nets
from benchmark.tests.test_bench_reference import DATA


def test_conv_and_attention_counts_match_hand_formulas():
    conv = nets.Conv(4, 6, 3, 1, 1, 3)
    attn = nets.AttentionBlock(8, 4, 2)
    x = torch.empty(2, 4, 5, 5, 5, device="meta")
    y = torch.empty(3, 8, 2, 3, 4, device="meta")  # 24 tokens, 2 heads of 4

    def fn():
        conv(x)
        with torch.no_grad():
            attn(y)

    got = rooflines.count(fn, (conv, attn), 2)
    conv_fl = 2 * 2 * 125 * 6 * 4 * 27
    S, T = 24, 3 * 24
    dense = 2 * T * 8 * 24 + 2 * T * 8 * 8  # qkv and out projections
    attn_fl = 4 * 3 * 2 * S * S * 4
    assert got["flops"] == conv_fl + dense + attn_fl
    assert got["attention"] == [(attn_fl, 4 * 3 * 2 * S * 4 * 2)]
    assert got["groupnorm"] == [(0, 2 * 3 * 8 * S * 2)]


def test_backward_counts_and_bounds():
    assert rooflines.attention_call(2, 1, 16, 8, 2, True) == [
        (4 * 2 * 16 * 16 * 8, 4 * 2 * 16 * 8 * 2), (8 * 2 * 16 * 16 * 8, 8 * 2 * 16 * 8 * 2)]
    assert rooflines.groupnorm_call(100, 2, True) == [(0, 400), (0, 600)]
    peak = {"bf16_flops": 1e12, "bytes_per_s": 1e9}
    assert rooflines.bound_s([(2e12, 1e9), (0, 3e9)], peak) == pytest.approx(2.0 + 3.0)
    assert rooflines.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12


@pytest.mark.parametrize("remat", [False, True])
def test_step_count_ignores_remat(remat):
    """The count is of the model, not of a recomputing implementation: the
    configuration's remat switch leaves it alone."""
    from benchmark.drivers import ldm_train

    spec = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))
    cell, _, _ = harness.load_cell(spec, os.path.join(DATA, "BENCHMARK.json"),
                                   [DATA, harness.BENCH_DIR], "tiny3d_train", 1, 0, False,
                                   require_card=False)
    base = ldm_train.flop_count(cell)
    cell.cfg["ddpm_params"]["use_checkpointing"] = remat
    cell.cfg["vae_params"]["use_checkpointing"] = remat
    again = ldm_train.flop_count(cell)
    assert again == base and base["flops"] > 0
    # the U-Net's GroupNorms forward and backward, the encoder's forward only
    unet, vae = ldm.models(cell.cfg)
    n_unet = sum(isinstance(m, nets.GroupNorm) for m in unet.modules())
    n_vae = sum(isinstance(m, nets.GroupNorm) for m in vae.encoder.modules())
    assert len(base["groupnorm"]) == 2 * n_unet + n_vae


def test_trace_reader():
    dev = [(0, 10, "flash_fwd_bf16"), (12, 20, "sm90_xmma_fprop"), (15, 18, "copy"),
           (30, 40, "gn_bwd_apply_kernel")]
    host = [(0, 50, "step"), (19, 31, "cudaStreamSynchronize"), (10, 13, "aten::copy_")]
    r = trace.read(dev, host, 50e-6, 1)
    assert r["busy_s"] == pytest.approx(28e-6)
    assert r["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(10e-6)]
    assert trace.family_seconds(r, ["flash", "fprop"]) == pytest.approx(18e-6)
