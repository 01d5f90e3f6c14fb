"""Which DepthTransformers take the fused depth-context chain (K1) in the
port: the JAX package's gate on the TPU (`models/unet.py::_fused_ok`,
lines 129-155, written out below because it answers False off the TPU),
for every DepthTransformer of `Config()` and of `configs/synth_scratch.yaml`
at serving and in training; each fused block's shape takes a K1 design and
each other block's a K3 plan. Then a tiny sampler trajectory whose blocks
are fused and unfused at serving by the pixel rule matches the JAX package
(tolerance 1e-4, as tests/test_torch_sampler.py), with each frustum width
taking the chain the gate names."""

from pathlib import Path

import pytest
import torch

import chip_smoke
from morphablediffusion_torch.models import unet as t_unet
from morphablediffusion_torch.ops import depth_attention as da
from morphablediffusion_torch.utils import config as t_config
from tests.tiny import tiny_config
from tests.torch_parity import assert_slice_matches, sampler_run

SYNTH_SCRATCH = Path(__file__).resolve().parents[1] / "configs" / "synth_scratch.yaml"


def jax_fused_ok(num_heads, head_dim, context_shape, train):
    """`DepthTransformer._fused_ok` of the JAX package on a TPU backend, for
    an initialized module; context_shape is the JAX (B, D, H, W, C)."""
    inner = num_heads * head_dim
    if inner % 128 != 0:
        return False
    if train:
        return context_shape[-2] >= 8
    return context_shape[-2] * context_shape[-3] >= 8


CONFIGS = {"Config": t_config.Config, "synth_scratch": lambda: t_config.load_config(SYNTH_SCRATCH)}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("train", [False, True])
def test_gate_is_the_jax_gate(name, train):
    cfg = CONFIGS[name]()
    B = cfg.data.batch_size if train else cfg.model.view_num
    routes = []
    for s in chip_smoke.depth_blocks(cfg, B, train):  # every width's blocks
        W, D, Cc, heads = s["W"], s["D"], s["Cc"], s["heads"]
        hd = Cc // 2  # the UNet's DepthTransformers: 4 heads of Cc / 2
        want = jax_fused_ok(heads, hd, (1, D, W, W, Cc), train)
        assert t_unet.fused_ok(heads, hd, W, W, train) == s["fused"] == want, (W, Cc)
        block = t_unet.DepthTransformer(heads, hd, 16, 16, Cc)
        assert block.fused(torch.zeros(1, Cc, D, W, W), train) == want
        if want:  # a K1 design takes the shape (ctx_design raises otherwise)
            da.ctx_design(B, W * W, Cc, 2 * Cc, heads)
        else:  # and a K3 plan the unfused chain's
            da.depth_plan(B, 2 * Cc, D, W * W, heads)
        routes.append((W, want))
    if name == "Config":  # every block at serving, W >= 8 in training
        assert all(f == (not train or W >= 8) for W, f in routes)
    else:  # only W=8 (Cc 64) in training; W=8 and W=4 at serving
        assert {W for W, f in routes if f} == ({8} if train else {8, 4})


def test_unfused_blocks_at_serving_match_jax(monkeypatch):
    """volume_dims (64, 64, 64, 64): every inner width is 128, so the pixel
    rule alone routes the tiny config's frustum widths 8 and 4 to K1 and 2
    and 1 to the unfused chain (the CFG-doubled batch included)."""
    cfg = tiny_config(view_num=2)
    cfg.model.unet.volume_dims = (64, 64, 64, 64)
    widths = {"fused": set(), "unfused": set()}
    ctx, plain = da.depth_attention_ctx, da.depth_attention

    def spy(kind, fn):
        def call(q, *args, **kwargs):
            widths[kind].add(q.shape[-1])
            return fn(q, *args, **kwargs)
        return call

    monkeypatch.setattr(da, "depth_attention_ctx", spy("fused", ctx))
    monkeypatch.setattr(da, "depth_attention", spy("unfused", plain))
    r = sampler_run(cfg)
    assert widths == {"fused": {8, 4}, "unfused": {2, 1}}
    assert_slice_matches(r)


@pytest.mark.parametrize("world,train", [(2, False), (4, False), (2, True)])
def test_a_rank_routes_as_one_card(world, train):
    """On one of `world` ranks a DepthTransformer sees N / world views at
    serving (a quarter or half of K1's batch) and batch_size / world samples
    in training: every block takes the chain it takes on one card, and a
    fused block the same K1 design (its G, or the cluster design's tiles a
    cluster, may differ with the batch)."""
    cfg = t_config.Config()
    B = cfg.data.batch_size if train else cfg.model.view_num
    one = chip_smoke.depth_blocks(cfg, B, train)
    rank = chip_smoke.depth_blocks(cfg, B // world, train)
    assert [s["fused"] for s in rank] == [s["fused"] for s in one]
    for a, b in zip(one, rank):
        assert b["B"] == a["B"] // world
        if a["fused"]:
            design = lambda s: da.ctx_design(s["B"], s["W"] ** 2, s["Cc"], s["Ci"], s["heads"])
            assert design(b).kernel == design(a).kernel, b
