"""W8A8 serving in the port (`morphablediffusion_torch/ops/int8.py`, the
`int8` convs of models/layers.py and `w8a8` of models/unet.py) against the
JAX package's (`morphablediffusion_tpu/ops/int8.py`, `Conv8`, `w8a8`) on the
CPU: the quantizers (int8 tensors equal, scales within 1 ulp), the int32
accumulators (exact) and the dequantized conv (1e-6 relative), then a tiny
W8A8 UNet and a tiny W8A8 sampler trajectory, each no further from JAX's
W8A8 result than a tenth of JAX's own W8A8-to-fp32 distance."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import unet as T
from morphablediffusion_torch.ops import int8 as tq
from morphablediffusion_torch.weights import cast_for_serving
from morphablediffusion_tpu.models import unet as J
from morphablediffusion_tpu.ops import int8 as jq
from tests.tiny import tiny_config
from tests.torch_parity import (cf, cl, load_into, sampler_run, seeded_tree, tt,
                                well_conditioned)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in fp32 units in the last place."""
    ia, ib = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    return int(np.abs(ia - ib).max())


def _weight(rng, shape, dtype):
    """(cout, cin, kh, kw) weight, one output channel 100x larger and one
    all zero (a zero-initialized conv), as torch and as JAX HWIO arrays."""
    w = rng.normal(size=shape).astype(np.float32) * 0.1
    w[0] *= 100.0
    w[1] = 0.0
    tw = torch.from_numpy(w).to(DTYPES[dtype][0])
    jw = jnp.asarray(w.transpose(2, 3, 1, 0)).astype(DTYPES[dtype][1])
    return tw, jw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_match_jax(rng, dtype):
    tw, jw = _weight(rng, (24, 16, 3, 3), dtype)
    w8, sw = tq.quantize_weight_per_channel(tw)
    jw8, jsw = jq.quantize_weight_per_channel(jw)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8).transpose(3, 2, 0, 1))
    assert w8.dtype == torch.int8 and sw.dtype == torch.float32
    assert _ulps(sw.numpy(), np.asarray(jsw)) <= 1
    assert int(w8[1].abs().max()) == 0

    x = rng.normal(size=(2, 16, 5, 7)).astype(np.float32) * 3.0
    tx = torch.from_numpy(x).to(DTYPES[dtype][0])
    x8, sx = tq.quantize_activation(tx)
    jx8, jsx = jq.quantize_activation(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(
        DTYPES[dtype][1]))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8).transpose(0, 3, 1, 2))
    assert _ulps(sx.numpy(), np.asarray(jsx)) <= 1


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_conv_accumulators_exact(rng, k, stride):
    pad = (k - 1) // 2
    x = rng.normal(size=(2, 16, 9, 8)).astype(np.float32)
    w = rng.normal(size=(24, 16, k, k)).astype(np.float32) * 0.1
    b = rng.normal(size=(24,)).astype(np.float32) * 0.1
    w8, sw = tq.quantize_weight_per_channel(torch.from_numpy(w))
    x8, _ = tq.quantize_activation(torch.from_numpy(x))
    acc = tq.conv2d_int8(x8, w8, stride, pad)
    jacc = jax.lax.conv_general_dilated(
        jnp.asarray(x8.numpy().transpose(0, 2, 3, 1)),
        jnp.asarray(w8.numpy().transpose(2, 3, 1, 0)),
        window_strides=(stride, stride), padding=((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))

    out = tq.conv2d_w8a8(torch.from_numpy(x), w8, sw, torch.from_numpy(b), stride, pad,
                         out_dtype=torch.float32)
    ref = jq.conv2d_w8a8(jnp.asarray(x.transpose(0, 2, 3, 1)),
                         jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b),
                         stride=stride, padding=pad, out_dtype=jnp.float32)
    np.testing.assert_allclose(cl(out).numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


def test_int_matmul_pads_to_the_shape_rules():
    """Rows <= 16 and k, n off a multiple of 8 (zero-padded for _int_mm's
    rules on the card) give the exact product."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (5, 13), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (13, 7), generator=g, dtype=torch.int8)
    assert torch.equal(tq.int_matmul(a, b), a.int() @ b.int())


def test_quantized_weight_follows_the_weight():
    """A conv quantizes once per weight load: the cache is reused until the
    weight is loaded or cast anew."""
    from morphablediffusion_torch.models.layers import Conv2d

    conv = Conv2d(8, 16, 3, int8=True)
    first = conv.quantized_weight()
    assert conv.quantized_weight()[0] is first[0]
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert conv.quantized_weight()[0] is not first[0]
    cast_for_serving(conv)
    w8, sw = conv.quantized_weight()
    ref8, refs = tq.quantize_weight_per_channel(conv.weight.detach())
    assert torch.equal(w8, ref8) and torch.equal(sw, refs)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tiny_w8a8_unet(rng):
    """Every int8 conv of a tiny DepthWiseUNet (model_channels 32) under
    the CFG doubled batch, against the JAX W8A8 UNet on the same
    well-conditioned seeded weights (as the sampler tests take them);
    input_conv and out_conv stay fp32 on both sides.

    The quantizer is discontinuous: an fp32 rounding difference (~1e-7
    here) that crosses a rounding boundary moves an int8 value by a whole
    step, and such flips can cascade through the UNet's int8 convs. On
    test_torch_unet.py's seeded weights (biases and norm scales drawn too)
    the port lands 0.053 from the JAX W8A8 output, whose own distance from
    fp32 is 0.057, while JAX's eager and jitted W8A8 agree; on these weights
    the port agrees with the jitted JAX output to ~4e-7 and JAX's eager W8A8
    lands 0.046 from it. Each block alone is exact (0.0) on both."""
    B, Bc, dims = 4, 2, (8, 16, 32, 64)
    x = rng.normal(size=(B, 8, 8, 8)).astype(np.float32)
    t = np.array([3, 500, 3, 500])
    context = rng.normal(size=(B, 1, 768)).astype(np.float32)
    src = {w: rng.normal(size=(Bc, w, w, w, c)).astype(np.float32)
           for w, c in zip((8, 4, 2, 1), dims)}
    kw = dict(model_channels=32, num_heads=4, volume_dims=dims)
    jsrc = {w: jnp.asarray(v) for w, v in src.items()}
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(context), jsrc)
    params = well_conditioned(seeded_tree(jax.eval_shape(
        lambda a, b, c, d: J.DepthWiseUNet(**kw).init(jax.random.key(0), a, b, c, d),
        jnp.asarray(x[:Bc]), jnp.asarray(t[:Bc]), jnp.asarray(context[:Bc]), jsrc)))
    run = lambda m: jax.jit(lambda p, *a: m.apply(p, *a, cfg_doubled=True))(params, *args)
    ref_q, ref_f = run(J.DepthWiseUNet(**kw, w8a8=True)), run(J.DepthWiseUNet(**kw))
    port = load_into(T.DepthWiseUNet(**kw, w8a8=True), params)
    n_int8 = sum(getattr(m, "int8", False) for m in port.modules())
    assert n_int8 > 0 and not port.input_conv.int8 and not port.out_conv.int8
    with torch.no_grad():
        out = port(cf(x), torch.from_numpy(t), tt(context),
                   {w: cf(v) for w, v in src.items()}, cfg_doubled=True)
    jax_gap = _rel(ref_q, ref_f)
    assert jax_gap > 1e-3  # the quantization is there to be seen
    assert _rel(cl(out).numpy(), ref_q) <= 0.1 * jax_gap


def test_tiny_w8a8_sampler_trajectory():
    """tests/tiny.py's sampler with unet.w8a8 on both sides (the same noise
    stream), every step and the decoded images held to a tenth of the JAX
    W8A8 trajectory's distance from the JAX fp32 one."""
    cfg = tiny_config(view_num=2)
    cfg8 = copy.deepcopy(cfg)
    cfg8.model.unet.w8a8 = True
    q = sampler_run(cfg8)
    f = sampler_run(cfg)
    assert len(q["t_traj"]) == q["traj"].shape[0] == 2
    for t_x, j_x, f_x in zip(q["t_traj"], q["traj"], f["traj"]):
        gap = _rel(j_x, f_x)
        assert gap > 1e-3
        assert _rel(t_x.numpy(), j_x) <= 0.1 * gap
    assert _rel(q["t_images"].numpy(), q["images"]) <= 0.1 * _rel(q["images"], f["images"])
    assert q["launches"] == (0,) * len(q["launches"])
