"""K4's two layouts: the rule that picks one from x's strides
(`kernel_layout`), the channels-last plan (`gn_plan(..., layout=NHWC)`), the
plain version on either layout, and, on the card, the channels-last design
against the plain version.

The CPU tests import neither JAX nor the JAX package. The card tests are
marked `cuda` and skip without a CUDA card; on the card:

    python -m pytest --noconftest -q tests/test_torch_group_norm_layout.py

Card tolerances as tests/test_torch_cuda.py: relative L2 1e-2 in bf16, 1e-5
in fp32, against `_reference` on the same inputs.
"""

import ctypes
import math

import pytest
import torch

from morphablediffusion_torch.models.layers import GroupNorm
from morphablediffusion_torch.ops import group_norm as gn

CL = torch.channels_last


def _cl(t):
    return t.contiguous(memory_format=CL)


# (what it is, a tensor made from a contiguous (2, 16, 4, 6), its layout for K4)
LAYOUT_CASES = [
    ("contiguous", lambda t: t, gn.NCHW),
    ("channels_last", _cl, gn.NHWC),
    ("transposed_hw", lambda t: t.transpose(2, 3), None),
    ("channel_slice_of_channels_last", lambda t: _cl(t)[:, :8], None),
    ("batch_slice_of_channels_last", lambda t: _cl(t)[1:], gn.NHWC),
    ("every_other_row", lambda t: t[:, :, ::2], None),
    ("volume", lambda t: t.reshape(2, 16, 2, 2, 6), gn.NCHW),
    ("volume_channels_last", lambda t: t.reshape(2, 16, 2, 2, 6).contiguous(
        memory_format=torch.channels_last_3d), None),
    ("rows", lambda t: t.reshape(2, 384), gn.NCHW),
    ("pixel_map_channels_last", lambda t: _cl(t[:, :, :1, :1]), gn.NCHW),
    ("pixel_map_contiguous", lambda t: t[:, :, :1, :1].contiguous(), gn.NCHW),
]


@pytest.mark.parametrize("name,make,want", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_kernel_layout_rule(name, make, want):
    """NCHW where x is contiguous (a (B, C, 1, 1) map is both, and NCHW
    wins), NHWC where a 4-D x is dense in channels-last, else None: copied
    to NCHW by `layers.GroupNorm` on the card."""
    x = make(torch.randn(2, 16, 4, 6))
    assert gn.kernel_layout(x) == want


# the VAE's maps (encode chunks of 16, the 70 inputs, decode) and the UNet's
# (CFG-doubled serving at 128, training at 70; cg 10 at C = 320, 40 at 1 280)
NHWC_SHAPES = [((16, 128, 256, 256), 32), ((16, 256, 128, 128), 32), ((16, 512, 64, 64), 32),
               ((16, 512, 32, 32), 32), ((70, 128, 256, 256), 32), ((70, 512, 32, 32), 32),
               ((4, 512, 32, 32), 32), ((16, 256, 256, 256), 32), ((16, 512, 128, 128), 32),
               ((128, 320, 32, 32), 32), ((128, 640, 16, 16), 32), ((128, 1280, 8, 8), 32),
               ((128, 1280, 4, 4), 32), ((70, 2560, 4, 4), 32), ((64, 128, 32, 32), 8),
               ((64, 16, 32, 32), 8), ((8, 64, 128, 128), 8), ((2, 12, 5, 7), 4),
               ((3, 40, 1, 2), 4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", NHWC_SHAPES)
def test_gn_plan_nhwc(shape, groups, dtype):
    """A cluster of at most 8 blocks a sample covers its rows; a block is
    whole rows of C / vec threads, each thread with GN_NHWC_MIN_ROWS of the
    block's rows where it has them; it holds all its rows where they take
    GN_NHWC_RESIDENT_BYTES or less, else GN_MAX_HELD_BYTES' worth; the
    shared memory is the kernel's layout."""
    plan = gn.gn_plan(shape, dtype, groups, layout=gn.NHWC)
    B, C = shape[:2]
    S = math.prod(shape[2:])
    esize = 4 if dtype == torch.float32 else 2
    assert plan.layout == gn.NHWC
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= S
    assert plan.blocks == B * plan.cluster
    assert plan.chunk * plan.cluster >= S > plan.chunk * (plan.cluster - 1)
    assert plan.vec == (16 // esize if C % (16 // esize) == 0 else 1)
    ry = gn.nhwc_rows(C, plan.vec, plan.chunk)
    assert plan.pack == ry and plan.threads == C // plan.vec * ry <= gn.GN_NHWC_MAX_THREADS
    assert ry == 1 or (plan.threads <= gn.GN_NHWC_THREADS
                       and ry * gn.GN_NHWC_MIN_ROWS <= plan.chunk)
    assert 0 <= plan.held <= plan.chunk
    assert plan.resident == (plan.held == plan.chunk)
    assert plan.smem == gn._gn_smem_nhwc(C, groups, ry, plan.held, esize) <= gn.GN_MAX_SMEM
    row = C * esize
    if plan.chunk * row <= gn.GN_NHWC_RESIDENT_BYTES:
        assert plan.resident
    else:
        assert plan.held == min(plan.chunk, gn.GN_MAX_HELD_BYTES // row)
    if plan.cluster > 1:  # split only to bound a block's share or to fill the card
        assert (S * C * esize > plan.cluster // 2 * gn.GN_TARGET_BYTES
                or B * plan.cluster // 2 < gn.GN_FILL)


def test_gn_plan_nhwc_of_the_vae():
    """The VAE encode's level 0 (16.8 MB a sample) goes to 8 blocks of 512
    threads that hold 32 KiB of their 2 MiB each; its level 3 (1 MB) to 8
    blocks that hold all of theirs (128 KiB), at any batch. The UNet's
    bottom at 8^2 takes a row at a time. A misaligned x takes one channel a
    slice; the NHWC plan is cached apart from the NCHW one."""
    top = gn.gn_plan((16, 128, 256, 256), torch.bfloat16, 32, layout=gn.NHWC)
    assert (top.cluster, top.chunk, top.threads, top.resident) == (8, 8192, 512, False)
    assert top.held * 128 * 2 == gn.GN_MAX_HELD_BYTES
    low = gn.gn_plan((16, 512, 32, 32), torch.bfloat16, 32, layout=gn.NHWC)
    assert (low.cluster, low.chunk, low.held, low.blocks) == (8, 128, 128, 128)
    wide = gn.gn_plan((70, 512, 32, 32), torch.bfloat16, 32, layout=gn.NHWC)
    assert (wide.blocks, wide.resident) == (560, True)
    bottom = gn.gn_plan((128, 1280, 8, 8), torch.bfloat16, 32, layout=gn.NHWC)
    assert (bottom.pack, bottom.threads, bottom.resident) == (1, 160, True)
    assert gn.gn_plan((16, 512, 32, 32), torch.bfloat16, 32, False, gn.NHWC).vec == 1
    assert gn.gn_plan((16, 512, 32, 32), torch.bfloat16, 32).layout == gn.NCHW


@pytest.mark.parametrize("shape,dtype,groups,match", [
    ((2, 16, 4, 4, 4), torch.bfloat16, 8, "4-D"),
    ((2, 1030, 4, 4), torch.bfloat16, 2, "threads"),
    ((2, 4100, 2, 2), torch.float32, 4, "threads"),
    ((1, 2, 2**16, 2**15), torch.bfloat16, 1, "2\\^31"),
    ((2, 64, 8, 8), torch.float16, 32, "bfloat16 or float32"),
    ((2, 64, 8, 8), torch.bfloat16, 24, "not divisible"),
])
def test_gn_plan_nhwc_refuses_what_the_kernel_cannot_take(shape, dtype, groups, match):
    with pytest.raises(ValueError, match=match):
        gn.gn_plan(shape, dtype, groups, layout=gn.NHWC)


def test_gn_plan_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="neither NCHW"):
        gn.gn_plan((2, 64, 8, 8), torch.bfloat16, 32, layout=2)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("act", [None, "silu", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 64, 16, 16), 32), ((3, 320, 8, 8), 32),
                                          ((2, 128, 32, 32), 32), ((2, 40, 5, 7), 4)])
def test_reference_takes_either_layout(shape, groups, dtype, act, shifted):
    """`_reference` on a channels-last x returns x's strides and the values
    of its contiguous copy up to the order of its fp32 sums: within 2e-6 in
    fp32 and one bf16 step in bf16. (Not to the bit: a sum over a strided
    axis runs in another order on the CPU, and the CPU path is kept as it
    is, the JAX parity tests' numbers with it.)"""
    g = torch.Generator().manual_seed(21)
    B, C = shape[:2]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(C, generator=g)
    beta = 0.1 * torch.randn(C, generator=g)
    shift = torch.randn(B, C, generator=g).to(dtype) if shifted else None
    xl = _cl(x)
    out = gn._reference(xl, shift, gamma, beta, groups, 1e-5, act)
    want = gn._reference(x, shift, gamma, beta, groups, 1e-5, act)
    assert out.stride() == xl.stride() and out.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_group_norm_layer_keeps_a_channels_last_map_on_the_cpu():
    """On the CPU the module copies nothing: a channels-last map comes back
    channels-last, within fp32 rounding of the contiguous input's values,
    and its gradient reaches x."""
    g = torch.Generator().manual_seed(22)
    mod = GroupNorm(8, 32, act="silu")
    x = torch.randn(2, 32, 6, 5, generator=g)
    xl = _cl(x).requires_grad_(True)
    out = mod(xl)
    assert out.is_contiguous(memory_format=CL) and not out.is_contiguous()
    torch.testing.assert_close(out, mod(x), rtol=2e-6, atol=2e-6)
    out.square().sum().backward()
    assert xl.grad is not None and xl.grad.abs().sum() > 0


# --- on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


# the VAE's level 0 and level 3, the UNet's cg = 10 and cg = 40, a map of one
# channel a slice (C not a multiple of 8) and one of two rows
CARD_SHAPES = [((16, 128, 256, 256), 32), ((16, 512, 32, 32), 32), ((16, 320, 32, 32), 32),
               ((16, 1280, 8, 8), 32), ((3, 12, 5, 7), 4), ((2, 40, 1, 2), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("act", [None, "silu", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", CARD_SHAPES)
def test_group_norm_nhwc_kernel(dev, shape, groups, dtype, act, shifted):
    """The channels-last design against the plain version: one launch,
    counted as NHWC, y in x's strides, the same bits twice."""
    g = torch.Generator(dev).manual_seed(23)
    B, C = shape[:2]
    x = _cl((torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype))
    gamma = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
    beta = 0.1 * torch.randn(C, generator=g, device=dev)
    shift = torch.randn(B, C, generator=g, device=dev).to(dtype) if shifted else None
    before, nhwc = gn.KERNEL.launches, gn.nhwc_launches
    out = gn.group_norm_shifted(x, shift, gamma, beta, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert (gn.KERNEL.launches, gn.nhwc_launches) == (before + 1, nhwc + 1)
    assert out.dtype == dtype and out.shape == x.shape and out.stride() == x.stride()
    want = gn._reference(x, shift, gamma, beta, groups, 1e-6, act)
    assert _rel(out, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    assert torch.equal(out, gn.group_norm_kernel(x, shift, gamma, beta, groups, 1e-6, act))


@pytest.mark.cuda
def test_group_norm_nhwc_plan_matches_the_kernel(dev):
    """The kernel's shared memory is the NHWC plan's, and the card holds at
    least one cluster of each, at every shape of the plan tests."""
    gn.KERNEL._load()
    lib = ctypes.CDLL(str(gn.KERNEL.lib_path()))
    for shape, groups in NHWC_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            p = gn.gn_plan(shape, dtype, groups, layout=gn.NHWC)
            args = (shape[1], groups, math.prod(shape[2:]), p.pack, p.cluster, p.chunk, p.held,
                    p.vec, gn._DTYPE_CODE[dtype], gn.NHWC)
            assert lib.md_group_norm_smem_bytes(*args) == p.smem, (shape, dtype)
            assert lib.md_group_norm_max_clusters(*args) >= 1, (shape, dtype)


@pytest.mark.cuda
def test_group_norm_refuses_2_to_31_pairs(dev):
    """The entry point refuses a call whose (sample, group) pairs reach
    2^31 (the NCHW design's group index is 32-bit) before it reads x."""
    gn.KERNEL._load()
    lib = ctypes.CDLL(str(gn.KERNEL.lib_path()))
    p = gn.gn_plan((2, 64, 8, 8), torch.bfloat16, 32)
    args = [64, 32, 64, p.pack, p.cluster, p.chunk, p.held, p.vec, ctypes.c_float(1e-5), 0, 1,
            0, gn.NCHW, None]
    assert lib.md_group_norm(None, None, None, None, None, 2**26, *args) != 0
    assert lib.md_group_norm(None, None, None, None, None, 2**26 - 1, *args[:12], gn.NHWC + 1,
                             None) != 0


@pytest.mark.cuda
def test_group_norm_nhwc_misaligned_and_through_autograd(dev):
    """A channels-last x 8 bytes off 16-byte alignment takes one channel a
    load; through the layer with a gradient to record, the output stays
    channels-last and the gradients reach x, gamma, beta and the shift."""
    g = torch.Generator(dev).manual_seed(24)
    x = _cl(torch.randn(4, 64, 16, 16, generator=g, device=dev).bfloat16())
    buf = torch.empty(x.numel() + 4, device=dev, dtype=x.dtype)[4:]
    odd = buf.as_strided(x.shape, x.stride()).copy_(x)
    assert gn.kernel_layout(odd) == gn.NHWC and odd.data_ptr() % 16
    gamma, beta = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    want = gn._reference(x, None, gamma, beta, 32, 1e-5, "silu")
    assert _rel(gn.group_norm(odd, gamma, beta, 32, 1e-5, "silu"), want) <= 1e-2

    mod = GroupNorm(32, 64, act="silu").to(dev)
    xl = x.detach().requires_grad_(True)
    shift = torch.randn(4, 64, generator=g, device=dev).bfloat16().requires_grad_(True)
    nhwc = gn.nhwc_launches
    out = mod(xl, shift)
    assert gn.nhwc_launches == nhwc + 1 and out.stride() == x.stride()
    out.float().square().sum().backward()
    for t in (xl, shift, mod.weight, mod.bias):
        assert t.grad is not None and t.grad.float().abs().sum() > 0
