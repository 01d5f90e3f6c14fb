"""Reference-checkpoint importer and exporter of the PyTorch port.

The port's own copy of the JAX package's `utils/torch_import.py`: the same
conversion kinds, layout conversions and mapping tables from the published
MorphableDiffusion / SyncDreamer / Stable-Diffusion `state_dict` names onto
the flax parameter paths, which the port's modules carry
(`weights.from_jax_params`):

  * SD VAE            (first_stage_model.*)
  * CLIP ViT-L/14     (clip_image_encoder.model.visual.*)
  * time-embed MLP    (time_embed.*)
  * denoiser UNet + DepthTransformers (model.diffusion_model.*)
  * conditioning nets (spatial_volume.target_encoder/.smpl_feature_extractor/
                       .frustum_volume_feats.*)
  * the reference's spconv net (spatial_volume.xyzc_net.*), mapped only when
    the model has the fine-grid conditioner (`mesh_voxel_mode: fine`); conv
    kernels, BN affine and BN running statistics.

Import: reference state_dict -> `_convert` -> a flat {flax path: array} ->
`weights.from_jax_params` -> `model.load_state_dict(..., strict=False)`.
The semantics are the JAX importer's: the 4->8 input-channel zero pad of
`input_blocks.0.0.weight` (plain SD weights), a shape mismatch raises,
checkpoint keys whose path the model lacks are reported as unmatched, keys
nothing maps (other than xyzc_net, the schedule buffers and the posterior
ones) are reported as unused, and parameters nothing maps keep what the
model holds. Export runs the inverse through `weights.to_jax_layout` and
`_deconvert`.

Layout conversions (torch -> flax, channels-last):
  conv2d (O,I,kh,kw)   -> (kh,kw,I,O)
  conv3d (O,I,kd,kh,kw)-> (kd,kh,kw,I,O)
  convT3d (I,O,kd,kh,kw)-> transpose to (kd,kh,kw,I,O) + spatial flip
  linear / 1x1 convs   -> kernel transposed to (I,O)
  norm weight/bias     -> scale/bias
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from morphablediffusion_torch import weights

# conversion kinds
CONV2 = "conv2"
CONV3 = "conv3"
CONVT3 = "convt3"
LINEAR = "linear"  # also conv1d/1x1 used as dense
NORM = "norm"
DIRECT = "direct"
SPCONV = "spconv"  # spconv 3D kernels (layout sniffed, see _convert)


def _convert(kind: str, name: str, w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, dtype=np.float32)
    if name == "bias" or kind == DIRECT:
        return w
    if kind == NORM:
        return w  # scale/bias are 1-D
    if kind == CONV2:
        return w.transpose(2, 3, 1, 0)
    if kind == CONV3:
        return w.transpose(2, 3, 4, 1, 0)
    if kind == CONVT3:
        w = w.transpose(2, 3, 4, 0, 1)  # (kd,kh,kw,I,O)
        return w[::-1, ::-1, ::-1].copy()
    if kind == SPCONV:
        # spconv stores 3D kernels as KRSC (O, kd, kh, kw, I) in 2.x — the
        # version the published checkpoints were written with (spconv-cu113)
        # — or spatial-first (kd, kh, kw, I, O) in 1.x. Sniff by where the
        # 3^3 spatial dims sit; both convert to flax (kd, kh, kw, I, O).
        if w.ndim == 5 and w.shape[:3] == (3, 3, 3):
            return w
        if w.ndim == 5 and w.shape[1:4] == (3, 3, 3):
            return w.transpose(1, 2, 3, 4, 0)
        raise ValueError(f"unrecognized spconv kernel layout {w.shape}")
    if kind == LINEAR:
        w = w.reshape(w.shape[0], -1)  # squeeze conv1d/1x1 spatial dims
        return w.transpose(1, 0)
    raise ValueError(kind)


def _deconvert(kind: str, name: str, w: np.ndarray) -> np.ndarray:
    """Inverse of `_convert`: flax layout -> torch state_dict layout.

    LINEAR caveat: torch keys that are Conv1d/1x1-Conv2d used as dense
    export as plain (O, I) matrices (the importer re-flattens them, so
    export->import round-trips exactly; loading into reference *torch*
    modules may need a trailing-dims reshape for those few keys)."""
    w = np.asarray(w, dtype=np.float32)
    if name == "bias" or kind in (DIRECT, NORM):
        return w
    if kind == CONV2:
        return w.transpose(3, 2, 0, 1)
    if kind == CONV3:
        return w.transpose(4, 3, 0, 1, 2)
    if kind == CONVT3:
        w = w[::-1, ::-1, ::-1]
        return w.transpose(3, 4, 0, 1, 2).copy()  # (I, O, kd, kh, kw)
    if kind == SPCONV:
        return w.transpose(4, 0, 1, 2, 3)  # spconv-2.x KRSC (O,kd,kh,kw,I)
    if kind == LINEAR:
        return w.transpose(1, 0)
    raise ValueError(kind)


def _norm(tkey: str, our: str) -> List[Tuple[str, str, str]]:
    """torch GroupNorm/LayerNorm weight/bias -> flax scale/bias."""
    return [
        (f"{tkey}.weight", f"{our}/scale", NORM),
        (f"{tkey}.bias", f"{our}/bias", NORM),
    ]


def _gn(tkey: str, our: str):
    """our GroupNorm wrapper owns scale/bias directly (fused kernel)."""
    return _norm(tkey, our)


def _wb(tkey: str, our: str, kind: str, bias: bool = True):
    out = [(f"{tkey}.weight", f"{our}/kernel", kind)]
    if bias:
        out.append((f"{tkey}.bias", f"{our}/bias", kind))
    return out


def _vae_resblock(t: str, o: str, has_shortcut: bool):
    m = (
        _gn(f"{t}.norm1", f"{o}/norm1")
        + _wb(f"{t}.conv1", f"{o}/conv1", CONV2)
        + _gn(f"{t}.norm2", f"{o}/norm2")
        + _wb(f"{t}.conv2", f"{o}/conv2", CONV2)
    )
    if has_shortcut:
        m += _wb(f"{t}.nin_shortcut", f"{o}/nin_shortcut", CONV2)
    return m


def _vae_attn(t: str, o: str):
    return (
        _gn(f"{t}.norm", f"{o}/norm")
        + _wb(f"{t}.q", f"{o}/q", CONV2)
        + _wb(f"{t}.k", f"{o}/k", CONV2)
        + _wb(f"{t}.v", f"{o}/v", CONV2)
        + _wb(f"{t}.proj_out", f"{o}/proj_out", CONV2)
    )


def vae_mapping() -> List[Tuple[str, str, str]]:
    t0 = "first_stage_model"
    o0 = "first_stage"
    ch = [128, 128, 256, 512, 512]  # per-level in-channels (ch_mult 1,2,4,4)
    m = _wb(f"{t0}.encoder.conv_in", f"{o0}/encoder/conv_in", CONV2)
    for lvl in range(4):
        for blk in range(2):
            has_sc = blk == 0 and ch[lvl] != ch[lvl + 1]
            m += _vae_resblock(
                f"{t0}.encoder.down.{lvl}.block.{blk}",
                f"{o0}/encoder/down_{lvl}_block_{blk}",
                has_sc,
            )
        if lvl < 3:
            m += _wb(
                f"{t0}.encoder.down.{lvl}.downsample.conv",
                f"{o0}/encoder/down_{lvl}_downsample",
                CONV2,
            )
    m += _vae_resblock(f"{t0}.encoder.mid.block_1", f"{o0}/encoder/mid_block_1", False)
    m += _vae_attn(f"{t0}.encoder.mid.attn_1", f"{o0}/encoder/mid_attn_1")
    m += _vae_resblock(f"{t0}.encoder.mid.block_2", f"{o0}/encoder/mid_block_2", False)
    m += _gn(f"{t0}.encoder.norm_out", f"{o0}/encoder/norm_out")
    m += _wb(f"{t0}.encoder.conv_out", f"{o0}/encoder/conv_out", CONV2)
    m += _wb(f"{t0}.quant_conv", f"{o0}/quant_conv", CONV2)
    m += _wb(f"{t0}.post_quant_conv", f"{o0}/post_quant_conv", CONV2)

    m += _wb(f"{t0}.decoder.conv_in", f"{o0}/decoder/conv_in", CONV2)
    m += _vae_resblock(f"{t0}.decoder.mid.block_1", f"{o0}/decoder/mid_block_1", False)
    m += _vae_attn(f"{t0}.decoder.mid.attn_1", f"{o0}/decoder/mid_attn_1")
    m += _vae_resblock(f"{t0}.decoder.mid.block_2", f"{o0}/decoder/mid_block_2", False)
    dch = [512, 512, 512, 256, 128]  # decoder in-channels walking levels 3..0
    for i, lvl in enumerate([3, 2, 1, 0]):
        cin, cout = dch[i], dch[i + 1]
        for blk in range(3):
            has_sc = blk == 0 and cin != cout
            m += _vae_resblock(
                f"{t0}.decoder.up.{lvl}.block.{blk}",
                f"{o0}/decoder/up_{lvl}_block_{blk}",
                has_sc,
            )
        if lvl != 0:
            m += _wb(
                f"{t0}.decoder.up.{lvl}.upsample.conv",
                f"{o0}/decoder/up_{lvl}_upsample",
                CONV2,
            )
    m += _gn(f"{t0}.decoder.norm_out", f"{o0}/decoder/norm_out")
    m += _wb(f"{t0}.decoder.conv_out", f"{o0}/decoder/conv_out", CONV2)
    return m


def clip_mapping(layers: int = 24) -> List[Tuple[str, str, str]]:
    t0 = "clip_image_encoder.model.visual"
    o0 = "clip_image_encoder"
    m = [
        (f"{t0}.conv1.weight", f"{o0}/patch_conv/kernel", CONV2),
        (f"{t0}.class_embedding", f"{o0}/class_embedding", DIRECT),
        (f"{t0}.positional_embedding", f"{o0}/positional_embedding", DIRECT),
        (f"{t0}.proj", f"{o0}/proj", DIRECT),
    ]
    m += _norm(f"{t0}.ln_pre", f"{o0}/ln_pre")
    m += _norm(f"{t0}.ln_post", f"{o0}/ln_post")
    for i in range(layers):
        t = f"{t0}.transformer.resblocks.{i}"
        o = f"{o0}/block_{i}"
        m += _norm(f"{t}.ln_1", f"{o}/ln_1")
        m += _norm(f"{t}.ln_2", f"{o}/ln_2")
        m += [
            (f"{t}.attn.in_proj_weight", f"{o}/attn/in_proj/kernel", LINEAR),
            (f"{t}.attn.in_proj_bias", f"{o}/attn/in_proj/bias", DIRECT),
        ]
        m += _wb(f"{t}.attn.out_proj", f"{o}/attn/out_proj", LINEAR)
        m += _wb(f"{t}.mlp.c_fc", f"{o}/mlp_fc", LINEAR)
        m += _wb(f"{t}.mlp.c_proj", f"{o}/mlp_proj", LINEAR)
    return m


def _unet_resblock(t: str, o: str):
    return (
        _gn(f"{t}.in_layers.0", f"{o}/norm_in")
        + _wb(f"{t}.in_layers.2", f"{o}/conv_in", CONV2)
        + _wb(f"{t}.emb_layers.1", f"{o}/emb_proj", LINEAR)
        + _gn(f"{t}.out_layers.0", f"{o}/norm_out")
        + _wb(f"{t}.out_layers.3", f"{o}/conv_out", CONV2)
        + _wb(f"{t}.skip_connection", f"{o}/skip", CONV2)  # dropped if absent
    )


def _unet_spatial_transformer(t: str, o: str, depth: int = 1):
    m = _gn(f"{t}.norm", f"{o}/norm")
    m += _wb(f"{t}.proj_in", f"{o}/proj_in", CONV2)
    for i in range(depth):
        tb = f"{t}.transformer_blocks.{i}"
        ob = f"{o}/block_{i}"
        for n in (1, 2, 3):
            m += _norm(f"{tb}.norm{n}", f"{ob}/norm{n}")
        for a in (1, 2):
            m += _wb(f"{tb}.attn{a}.to_q", f"{ob}/attn{a}/to_q", LINEAR, bias=False)
            m += _wb(f"{tb}.attn{a}.to_k", f"{ob}/attn{a}/to_k", LINEAR, bias=False)
            m += _wb(f"{tb}.attn{a}.to_v", f"{ob}/attn{a}/to_v", LINEAR, bias=False)
            m += _wb(f"{tb}.attn{a}.to_out.0", f"{ob}/attn{a}/to_out", LINEAR)
        m += _wb(f"{tb}.ff.net.0.proj", f"{ob}/ff/proj_in", LINEAR)
        m += _wb(f"{tb}.ff.net.2", f"{ob}/ff/proj_out", LINEAR)
    m += _wb(f"{t}.proj_out", f"{o}/proj_out", CONV2)
    return m


def _depth_transformer(t: str, o: str):
    return (
        _wb(f"{t}.proj_in.0", f"{o}/proj_in_conv", CONV2)
        + _gn(f"{t}.proj_in.1", f"{o}/proj_in_norm")
        + _wb(f"{t}.proj_context.0", f"{o}/proj_context_conv", LINEAR, bias=False)
        + _gn(f"{t}.proj_context.1", f"{o}/proj_context_norm")
        + _wb(f"{t}.depth_attn.to_q", f"{o}/depth_attn/to_q", LINEAR, bias=False)
        + _wb(f"{t}.depth_attn.to_k", f"{o}/depth_attn/to_k", LINEAR, bias=False)
        + _wb(f"{t}.depth_attn.to_v", f"{o}/depth_attn/to_v", LINEAR, bias=False)
        + _wb(f"{t}.depth_attn.to_out", f"{o}/depth_attn/to_out", LINEAR, bias=False)
        + _gn(f"{t}.proj_out.0", f"{o}/proj_out_norm0")
        + _wb(f"{t}.proj_out.2", f"{o}/proj_out_conv0", CONV2, bias=False)
        + _gn(f"{t}.proj_out.3", f"{o}/proj_out_norm1")
        + _wb(f"{t}.proj_out.5", f"{o}/proj_out_conv1", CONV2, bias=False)
    )


def unet_mapping() -> List[Tuple[str, str, str]]:
    t0 = "model.diffusion_model"
    o0 = "unet"
    m = _wb(f"{t0}.time_embed.0", f"{o0}/time_embed/dense0", LINEAR)
    m += _wb(f"{t0}.time_embed.2", f"{o0}/time_embed/dense1", LINEAR)
    m += _wb(f"{t0}.input_blocks.0.0", f"{o0}/input_conv", CONV2)

    attn_blocks = {1, 2, 4, 5, 7, 8}
    down_blocks = {3, 6, 9}
    for i in range(1, 12):
        t = f"{t0}.input_blocks.{i}"
        if i in down_blocks:
            m += _wb(f"{t}.0.op", f"{o0}/in_{i}_down/op", CONV2)
            continue
        m += _unet_resblock(f"{t}.0", f"{o0}/in_{i}_res")
        if i in attn_blocks:
            m += _unet_spatial_transformer(f"{t}.1", f"{o0}/in_{i}_attn")

    m += _unet_resblock(f"{t0}.middle_block.0", f"{o0}/mid_res0")
    m += _unet_spatial_transformer(f"{t0}.middle_block.1", f"{o0}/mid_attn")
    m += _unet_resblock(f"{t0}.middle_block.2", f"{o0}/mid_res1")
    m += _depth_transformer(f"{t0}.middle_conditions", f"{o0}/middle_conditions")

    out_attn = set(range(3, 12))  # decoder attn at ds 4,2,1 (blocks 3..11)
    up_blocks = {2: 1, 5: 2, 8: 2}  # block idx -> torch submodule idx of Upsample
    for i in range(12):
        t = f"{t0}.output_blocks.{i}"
        m += _unet_resblock(f"{t}.0", f"{o0}/out_{i}_res")
        if i in out_attn:
            m += _unet_spatial_transformer(f"{t}.1", f"{o0}/out_{i}_attn")
        if i in up_blocks:
            m += _wb(f"{t}.{up_blocks[i]}.conv", f"{o0}/out_{i}_up/conv", CONV2)
    for j in range(9):
        m += _depth_transformer(
            f"{t0}.output_conditions.{j}", f"{o0}/out_{j + 3}_cond"
        )
    m += _gn(f"{t0}.out.0", f"{o0}/out_norm")
    m += _wb(f"{t0}.out.2", f"{o0}/out_conv", CONV2)
    return m


def conditioning_mapping() -> List[Tuple[str, str, str]]:
    m = _wb("time_embed.0", "time_embed/dense0", LINEAR)
    m += _wb("time_embed.2", "time_embed/dense1", LINEAR)

    t0 = "spatial_volume.target_encoder"
    o0 = "spatial_volume/target_encoder"
    m += _wb(f"{t0}.init_conv", f"{o0}/init_conv", CONV2)
    for i in range(3):
        t = f"{t0}.out_conv{i}"
        o = f"{o0}/res_{i}"
        m += _wb(f"{t}.time_embed", f"{o}/time_embed", LINEAR)
        m += _wb(f"{t}.view_embed", f"{o}/view_embed", LINEAR)
        m += _gn(f"{t}.conv.0", f"{o}/norm0")
        m += _wb(f"{t}.conv.2", f"{o}/conv0", CONV2)
        m += _gn(f"{t}.conv.3", f"{o}/norm1")
        m += _wb(f"{t}.conv.5", f"{o}/conv1", CONV2)
    m += _gn(f"{t0}.final_out.0", f"{o0}/final_norm")
    m += _wb(f"{t0}.final_out.2", f"{o0}/final_conv", CONV2)

    m += _wb(
        "spatial_volume.smpl_feature_extractor.conv0",
        "spatial_volume/smpl_feature_extractor/conv0",
        LINEAR,
    )

    t0 = "spatial_volume.frustum_volume_feats"
    o0 = "spatial_volume/frustum_volume_feats"
    m += _wb(f"{t0}.conv0", f"{o0}/conv0", CONV3)
    for i in range(1, 7):
        t = f"{t0}.conv{i}"
        o = f"{o0}/conv{i}"
        m += _wb(f"{t}.t_conv", f"{o}/t_conv", LINEAR)
        m += _wb(f"{t}.v_conv", f"{o}/v_conv", LINEAR)
        m += _gn(f"{t}.bn", f"{o}/bn")
        m += _wb(f"{t}.conv", f"{o}/conv", CONV3)
    for i in range(3):
        t = f"{t0}.up{i}"
        o = f"{o0}/up{i}"
        m += _wb(f"{t}.t_conv", f"{o}/t_conv", LINEAR)
        m += _wb(f"{t}.v_conv", f"{o}/v_conv", LINEAR)
        m += _gn(f"{t}.norm", f"{o}/norm")
        m += _wb(f"{t}.conv", f"{o}/conv", CONVT3)
    return m


def xyzc_mapping() -> List[Tuple[str, str, str]]:
    """Reference spconv SparseConvNet (network.py:74-96) -> FineMeshVoxelNet.
    Torch keys follow the SparseSequential indices (conv at 0/3/6, BN right
    after each); BN running stats import as FROZEN mean/var params."""
    t0 = "spatial_volume.xyzc_net"
    o0 = "spatial_volume/mesh_voxel/net"
    m = []
    for blk, idxs in [("conv0", (0, 3)), ("down0", (0,)), ("conv1", (0, 3)),
                      ("down1", (0,)), ("conv2", (0, 3, 6))]:
        for i in idxs:
            m.append((f"{t0}.{blk}.{i}.weight", f"{o0}/{blk}_{i}/kernel",
                      SPCONV))
            bn = i + 1
            m += [
                (f"{t0}.{blk}.{bn}.weight", f"{o0}/{blk}_{bn}/scale", NORM),
                (f"{t0}.{blk}.{bn}.bias", f"{o0}/{blk}_{bn}/bias", NORM),
                (f"{t0}.{blk}.{bn}.running_mean", f"{o0}/{blk}_{bn}/mean",
                 DIRECT),
                (f"{t0}.{blk}.{bn}.running_var", f"{o0}/{blk}_{bn}/var",
                 DIRECT),
            ]
    return m


def full_mapping(clip_layers: int = 24) -> List[Tuple[str, str, str]]:
    return (
        vae_mapping()
        + clip_mapping(clip_layers)
        + unet_mapping()
        + conditioning_mapping()
    )



# the model path of the fine-grid conditioner's spconv net
_FINE_NET = "spatial_volume/mesh_voxel/net/"
INPUT_CONV_KEY = "model.diffusion_model.input_blocks.0.0.weight"


def _mapping(paths, clip_layers: int):
    """full_mapping, plus xyzc_mapping when `paths` (flax paths of the
    model) hold the fine-grid conditioner's net."""
    mapping = full_mapping(clip_layers)
    if any(p.startswith(_FINE_NET) for p in paths):
        mapping = mapping + xyzc_mapping()
    return mapping


def export_state_dict(model: torch.nn.Module, clip_layers: int = 24) -> Dict[str, np.ndarray]:
    """The model's parameters -> a reference-naming state_dict of fp32
    numpy arrays (the importer's inverse; export -> import round-trips
    exactly). Only mapped paths that the model has are written."""
    flat = weights.to_jax_layout(model, dict(model.named_parameters()))
    return {tkey: _deconvert(kind, opath.rsplit("/", 1)[-1], flat[opath])
            for tkey, opath, kind in _mapping(flat, clip_layers) if opath in flat}


def export_torch_checkpoint(model, path, dtype: torch.dtype = torch.float32) -> int:
    """Save the model as a reference-style torch .ckpt ({"state_dict": ...})
    with its tensors in `dtype`; returns the number of tensors."""
    sd = export_state_dict(model, clip_layers=model.cfg.clip.layers)
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
                               for k, v in sd.items()}}, path)
    return len(sd)


def import_state_dict(state_dict: Dict[str, np.ndarray], model: torch.nn.Module,
                      clip_layers: int = 24) -> Dict:
    """Load a reference state_dict into `model` in place (strict=False).

    Returns the report: `filled` (tensors loaded), `unused_torch_keys`
    (sorted) and `unmatched_model_paths` (mapped paths the model lacks)."""
    shapes = weights.jax_shapes(model)
    if INPUT_CONV_KEY in state_dict:
        # input-conv surgery: pad 4 -> 8 in-channels with zeros
        # (train_morphable_diffusion.py:197-213)
        w = np.asarray(state_dict[INPUT_CONV_KEY])
        want_in = shapes["unet/input_conv/kernel"][2]
        if w.shape[1] < want_in:
            pad = np.zeros((w.shape[0], want_in - w.shape[1]) + w.shape[2:], w.dtype)
            state_dict = dict(state_dict)
            state_dict[INPUT_CONV_KEY] = np.concatenate([w, pad], axis=1)

    used, missing_model, flat, filled = set(), [], {}, 0
    for tkey, opath, kind in _mapping(shapes, clip_layers):
        if tkey not in state_dict:
            continue
        value = _convert(kind, opath.rsplit("/", 1)[-1], np.asarray(state_dict[tkey]))
        if opath not in shapes:
            missing_model.append(opath)
            continue
        if tuple(shapes[opath]) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {opath}: ckpt {value.shape} vs model "
                             f"{shapes[opath]}")
        flat[opath] = value
        used.add(tkey)
        filled += 1

    device = next(model.parameters()).device
    result = model.load_state_dict(weights.from_jax_params(flat, device=device), strict=False)
    if result.unexpected_keys:
        raise ValueError(f"paths the model lacks: {result.unexpected_keys[:5]}")
    unused = [
        k for k in state_dict
        if k not in used and not k.startswith("spatial_volume.xyzc_net")
        and "alphas" not in k and not k.startswith("betas")
        and "posterior" not in k
    ]
    return {"filled": filled, "unused_torch_keys": sorted(unused),
            "unmatched_model_paths": missing_model}


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """torch .ckpt / .pt file -> flat {key: numpy} state dict. The file is
    unpickled whole (weights_only=False, as the published checkpoints hold
    more than tensors): read only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    return {k: v.numpy() for k, v in state_dict.items() if hasattr(v, "numpy")}


def import_torch_checkpoint(path, model: torch.nn.Module, state_dict=None) -> Dict:
    """Load a torch .ckpt / .pt file into `model` in place and print the
    import line; returns the report. `state_dict` short-circuits the file
    read when the caller already peeked at the checkpoint (generate_face's
    fine-conditioner auto-select)."""
    if state_dict is None:
        state_dict = load_torch_state_dict(path)
    report = import_state_dict(state_dict, model, clip_layers=model.cfg.clip.layers)
    print(
        f"imported {report['filled']} tensors; "
        f"{len(report['unused_torch_keys'])} torch keys unused; "
        f"{len(report['unmatched_model_paths'])} model paths unmatched"
    )
    return report
