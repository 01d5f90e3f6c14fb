"""Operations and bytes: the hand-written kernels' bounds and the model's
FLOPs, from shapes alone.

Bound of a kernel launch = max(FLOPs / peak FLOP/s, bytes / 3.35 TB/s),
each input read once and each output written once (bf16 at 989 TFLOP/s;
the GroupNorm kernel K4 at the 67 TFLOP/s outside the tensor cores),
whatever the kernel reads again. The peaks are one H100 SXM's published
dense rates at its 700 W limit.

The model's FLOPs are the products and convolutions of the plain
reference at the cell's shapes, counted by `FlopCounterMode` on the meta
device; the fine conditioner at the work its inputs need: every active
site times its active 3^3 neighbours times C_in x C_out x 2 (the sparse
convolution of the published model, not a dense emulation of it).
"""

from __future__ import annotations

import torch

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# the program's kernel objects (ops/*.py `CudaKernel.name`) -> their
# device symbols in a trace
SYMBOLS = {
    "depth_attention_ctx": "depth_ctx_kernel",
    "depth_attention_ctx_wgmma": "md_ctx_wgmma_kernel",
    "depth_attention_ctx_cluster": "md_ctx_cluster_kernel",
    "flash_attention": "md_flash_fwd_kernel",
    "flash_attention_bwd_dkv": "md_flash_bwd_dkv_kernel",
    "flash_attention_bwd_dq": "md_flash_bwd_dq_kernel",
    "depth_attention": "md_depth_attn_kernel",
    "group_norm": "md_group_norm_kernel",
}


def program_kernels():
    """The program's CudaKernel objects, found in its ops modules."""
    from morphablediffusion_torch.ops import depth_attention, flash_attention, group_norm

    found = {}
    for mod in (depth_attention, flash_attention, group_norm):
        for v in vars(mod).values():
            if type(v).__name__ == "CudaKernel":
                found[v.name] = v
    return found


def launch_counts() -> dict:
    """{kernel: launches so far}: the program's own counter."""
    return {k: v.launches for k, v in program_kernels().items()}


class LaunchRecorder:
    """While on, keeps the integer arguments (the shapes) of every launch of
    the program's kernels, in order, by wrapping each kernel object's
    `launch` on the instance."""

    def __init__(self, on: bool):
        self.records = []
        self.kernels = program_kernels() if on else {}
        for name, k in self.kernels.items():
            inner = k.launch

            def launch(*args, name=name, inner=inner):
                self.records.append((name, args[:-1]))
                return inner(*args)

            k.launch = launch

    def close(self):
        for k in self.kernels.values():
            k.__dict__.pop("launch", None)


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


def k1_cost(B, D, S, Cc, Ci):
    """K1: proj (Cc x Cc) -> affine+relu -> k, v (Ci x Cc each) -> depth
    attention, for q (B, Ci, S), ctx (B, Cc, D, S); bf16 in and out, the
    per-(sample, channel) affine in fp32."""
    flops = 2 * B * D * S * (Cc * Cc + 2 * Cc * Ci) + 4 * B * D * S * Ci
    nbytes = 2 * (B * Ci * S + B * Cc * D * S + Cc * Cc + 2 * Ci * Cc + B * Ci * S) + 8 * B * Cc
    return flops, nbytes


def k2_cost(B, L, H, hd):
    """K2 forward: q, k, v, out (B, L, H*hd) bf16, the row logsumexp fp32."""
    return 4 * B * H * L * L * hd, 2 * 4 * B * L * H * hd + 4 * B * H * L


def k2_dkv_cost(B, L, H, hd):
    """K2-dkv: logits again, dP, dV, dK; reads q, k, v, dout, lse, di,
    writes dk, dv."""
    return 8 * B * H * L * L * hd, 2 * 6 * B * L * H * hd + 8 * B * H * L


def k2_dq_cost(B, L, H, hd):
    """K2-dq: logits again, dP, dQ; reads q, k, v, dout, lse, di, writes dq."""
    return 6 * B * H * L * L * hd, 2 * 5 * B * L * H * hd + 8 * B * H * L


def k3_cost(B, C, D, S):
    """K3: depth attention of q (B, C, S) over k, v (B, C, D, S), bf16."""
    return 4 * B * C * D * S, 2 * (2 * B * C * S + 2 * B * C * D * S)


def k4_cost(B, C, S, esize, shift_esize):
    """K4: GroupNorm (+shift, +activation) of (B, C, S): sums, squares and
    the affine apply, 8 operations an element; x read, y written once."""
    return 8 * B * C * S, 2 * B * C * S * esize + B * C * shift_esize + 8 * C


def launch_bound_s(kernel: str, ints) -> float:
    """Bound of one launch from its arguments (pointers first, then the
    shapes), in the order of the program's C entry points (ops/*.py)."""
    if kernel.startswith("depth_attention_ctx"):
        B, D, S, Cc, Ci = ints[8:13]
        return bound_s(*k1_cost(B, D, S, Cc, Ci))
    if kernel == "flash_attention":
        return bound_s(*k2_cost(*ints[5:9]))
    if kernel == "flash_attention_bwd_dkv":
        return bound_s(*k2_dkv_cost(*ints[8:12]))
    if kernel == "flash_attention_bwd_dq":
        return bound_s(*k2_dq_cost(*ints[7:11]))
    if kernel == "depth_attention":
        B, C, D, S = ints[4:8]
        return bound_s(*k3_cost(B, C, D, S))
    if kernel == "group_norm":
        B, C, _G, S = ints[5:9]
        dtype, shift = ints[16], ints[17]
        esize = {0: 4, 1: 2}[dtype]
        return bound_s(*k4_cost(B, C, S, esize, {0: 0, 1: 4, 2: 2}[shift]), PEAK_FP32)
    raise KeyError(kernel)


def _meta_flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def sparse_conv_flops(batch, model_cfg) -> int:
    """The fine conditioner's work on this batch's vertices: for every
    sparse convolution, active outputs x active 3^3 neighbours x Cin x
    Cout x 2."""
    from h100_bench import reference as R

    total = 0
    voxel = model_cfg["fine_voxel_size"]
    for v, m in zip(batch["vertices"], batch["vertex_mask"]):
        dhw = v[m > 0].flip(-1).float()
        mn = dhw.amin(0)
        out_sh = (torch.ceil((dhw.amax(0) - mn) / voxel).long() | 3) + 1
        coords = torch.unique(torch.round((dhw - mn) / voxel).long(), dim=0)
        sites = R.SparseSites(coords, out_sh.tolist())
        offs = R.OFFSETS.to(coords.device)
        for _name, cin, cout, stride in R.SparseConvNet.PLAN:
            if stride:
                new = R.down_sites(sites, [s // 2 for s in sites.shape])
            else:
                new = sites
            hits = sum(int((sites.lookup(new.coords * (stride or 1) + o) >= 0).sum())
                       for o in offs)
            total += 2 * hits * cin * cout
            sites = new
    return total


def serving_flops(model_cfg, traffic, batch, steps: int) -> float:
    """FLOPs of one sampler call: prepare, `steps` CFG steps, decode."""
    from h100_bench import reference as R

    with torch.device("meta"):
        ref = R.Reference(model_cfg)
    B, N, S = traffic["batch"], model_cfg["view_num"], model_cfg["image_size"]
    h = S // 8
    meta = lambda *s: torch.zeros(*s, device="meta")
    fine = model_cfg["mesh_voxel_mode"] == "fine"

    def prepare():
        ref.clip(meta(B, S, S, 3))
        ref.encode(meta(B, S, S, 3))

    def step_dense():
        sv = ref.spatial_volume
        sv.target_encoder(meta(B * N, 4, h, h), meta(B * N, model_cfg["time_embed_dim"]),
                          meta(B * N, model_cfg["viewpoint_dim"]))
        ref.time_embed(meta(B, model_cfg["time_embed_dim"]))
        if not fine:
            g = model_cfg["voxel_grid_shape"]
            x = meta(B, 16, *g)
            for i, _ in enumerate(R.CoarseMeshVoxelNet.CHANNELS):
                x = getattr(sv.mesh_voxel, f"conv{i}")(x)
        D = model_cfg["frustum_volume_depth"]
        vols = sv.frustum_volume_feats(meta(B * N, 64, D, h, h),
                                       meta(B * N, model_cfg["time_embed_dim"]),
                                       meta(B * N, model_cfg["viewpoint_dim"]))
        for _ in range(2):  # conditional and unconditional
            ref.unet(meta(B * N, 8, h, h), meta(B * N), meta(B * N, 1, 768), vols)

    def decode():
        ref.decode(meta(B * N, h, h, 4))

    per_step = _meta_flops(step_dense)
    if fine:
        per_step += sparse_conv_flops(batch, model_cfg)
    return float(_meta_flops(prepare) + steps * per_step + _meta_flops(decode))


def training_flops(model_cfg, traffic) -> float:
    """FLOPs of one training step at the traffic's batch: the frozen
    encoders forward, the rest forward and backward (recomputation not
    counted)."""
    from h100_bench import reference as R

    if model_cfg["mesh_voxel_mode"] != "coarse":
        raise ValueError("training FLOPs are counted for the coarse conditioner")
    with torch.device("meta"):
        ref = R.Reference(model_cfg)
    B, N, S = traffic["batch"], model_cfg["view_num"], model_cfg["image_size"]
    h = S // 8
    meta = lambda *s: torch.zeros(*s, device="meta")

    def frozen():
        ref.encode(meta(B * N + B, S, S, 3))
        ref.clip(meta(B, S, S, 3))

    def trained():
        sv = ref.spatial_volume
        td, vd = model_cfg["time_embed_dim"], model_cfg["viewpoint_dim"]
        loss = sv.target_encoder(meta(B * N, 4, h, h), meta(B * N, td), meta(B * N, vd)).sum()
        loss = loss + ref.time_embed(meta(B, td)).sum()
        x = meta(B, 16, *model_cfg["voxel_grid_shape"])
        for i, _ in enumerate(R.CoarseMeshVoxelNet.CHANNELS):
            x = getattr(sv.mesh_voxel, f"conv{i}")(x)
        loss = loss + x.sum()
        D = model_cfg["frustum_volume_depth"]
        vols = sv.frustum_volume_feats(meta(B, 64, D, h, h), meta(B, td), meta(B, vd))
        loss = loss + ref.unet(meta(B, 8, h, h), meta(B), meta(B, 1, 768), vols).sum()
        loss.backward()

    return float(_meta_flops(frozen) + _meta_flops(trained))
