"""IR-SE50 (ArcFace) face descriptor, the Re-ID backend.

Counterpart of the JAX package's `eval/irse.py`. The reference's Re-ID
metric runs dlib's face_recognition_model_v1 and counts generated views
whose descriptor distance to the ground-truth view is < 0.6
(eval/eval_2d_facescape.py:97-108). The in-repo backend is the IR-SE50
ArcFace backbone the reference vendors at ldm/thirdp/psp/{model_irse,
helpers}.py: input conv/BN/PReLU, 4 stages of [3, 4, 14, 3] squeeze-excite
IR bottlenecks, a BN/flatten/linear/BN head and an l2-normalized 512-d
output. The modules carry the reference `Backbone(112, 50, 'ir_se')`'s
names (`input_layer.{0,1,2}`, `body.N.shortcut_layer`,
`body.N.res_layer.{0..5}`, `output_layer.{0,3,4}`), so the published
`model_ir_se50.pth` loads with `load_state_dict(strict=True)`
(`load_irse50`, also under the IDFeatures wrapper's `facenet.` prefix).

Inference only: every BatchNorm is its frozen running-statistics form (eps
1e-5) and dropout is the identity, as `Backbone.eval()` in the reference's
IDFeatures wrapper (ldm/thirdp/psp/id_loss.py:11-14). PReLU is per channel,
the SE convs have no bias, and the shortcut where in == depth is a strided
slice (the reference's 1-kernel max-pool).

Distances are Euclidean between l2-normalized descriptors, like dlib's; the
0.6 threshold was calibrated for dlib's ResNet and does NOT transfer to
IR-SE50's distance scale, so eval_2d requires an explicit --reid_threshold
with this backend (calibrate one with `apps/calibrate_reid.py`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch.utils.torch_import import CONV2, DIRECT, LINEAR, NORM, _deconvert

# stage plan: (in_channel, depth, num_units); the first unit of each stage
# strides 2 (helpers.get_blocks(50))
STAGES: Tuple[Tuple[int, int, int], ...] = (
    (64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3),
)


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm (the reference's BatchNorm2d or BatchNorm1d: the same
    state_dict) in inference form, whatever the module's training flag."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class SEModule(nn.Module):
    """Squeeze-excite: global pool -> 1x1 C/16 -> ReLU -> 1x1 C -> sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    """bottleneck_IR_SE: BN -> 3x3 -> PReLU -> 3x3(stride) -> BN -> SE, plus
    a shortcut (a strided slice when in == depth, else 1x1(stride) + BN)."""

    def __init__(self, in_ch: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if in_ch != depth:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_ch, depth, 1, stride, bias=False), FrozenBatchNorm(depth))
        else:
            self.shortcut_layer = None
        self.res_layer = nn.Sequential(
            FrozenBatchNorm(in_ch),
            nn.Conv2d(in_ch, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            FrozenBatchNorm(depth),
            SEModule(depth),
        )

    def forward(self, x):
        if self.shortcut_layer is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class IRSE50(nn.Module):
    """(B, 3, 112, 112) in [-1, 1] -> l2-normalized (B, 512) descriptor."""

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), FrozenBatchNorm(64), nn.PReLU(64))
        self.body = nn.Sequential(*[
            BottleneckIRSE(in_ch if u == 0 else depth, depth, 2 if u == 0 else 1)
            for in_ch, depth, units in STAGES for u in range(units)])
        self.output_layer = nn.Sequential(
            FrozenBatchNorm(512), nn.Identity(), nn.Flatten(),  # dropout: identity (eval)
            nn.Linear(512 * 7 * 7, 512), FrozenBatchNorm(512))

    def forward(self, x):
        h = self.output_layer(self.body(self.input_layer(x)))
        return h / torch.linalg.norm(h, dim=-1, keepdim=True)


def seeded_irse50(seed: int = 0) -> IRSE50:
    """IR-SE50 at PyTorch's default initialization, drawn under `seed`
    (the global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return IRSE50().eval()


def load_irse50(path, device) -> IRSE50:
    """IR-SE50 from a reference state_dict file (`model_ir_se50.pth`, bare or
    under the `facenet.` prefix, or a {"state_dict": ...} file), loaded
    strictly; a file without BatchNorm's `num_batches_tracked` counters
    (older PyTorch) keeps the module's."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if any(k.startswith("facenet.") for k in sd):
        sd = {k[len("facenet."):]: v for k, v in sd.items() if k.startswith("facenet.")}
    net = IRSE50()
    own = net.state_dict()
    sd = {**{k: v for k, v in own.items() if k.endswith("num_batches_tracked")}, **sd}
    net.load_state_dict(sd, strict=True)
    return net.to(device).eval()


# --------------------------------------------------------------------- #
# the JAX IRSE50 tree -> the port's state_dict

LINEAR_CF = "linear_cf"  # torch Linear over a channels-first flatten


def _bn(tprefix: str, opath: str) -> List[Tuple[str, str, str]]:
    return [
        (f"{tprefix}.weight", f"{opath}/scale", NORM),
        (f"{tprefix}.bias", f"{opath}/bias", NORM),
        (f"{tprefix}.running_mean", f"{opath}/mean", DIRECT),
        (f"{tprefix}.running_var", f"{opath}/var", DIRECT),
    ]


def irse_mapping() -> List[Tuple[str, str, str]]:
    """torch Backbone(112, 50, 'ir_se') state_dict -> JAX IRSE50 param paths."""
    m: List[Tuple[str, str, str]] = [
        ("input_layer.0.weight", "input_conv/kernel", CONV2),
        ("input_layer.2.weight", "input_prelu/weight", DIRECT),
    ]
    m += _bn("input_layer.1", "input_bn")
    i = 0
    for in_ch, depth, units in STAGES:
        for u in range(units):
            t = f"body.{i}"
            o = f"body_{i}"
            if u == 0 and in_ch != depth:  # else: maxpool, no params
                m.append((f"{t}.shortcut_layer.0.weight",
                          f"{o}/shortcut_conv/kernel", CONV2))
                m += _bn(f"{t}.shortcut_layer.1", f"{o}/shortcut_bn")
            m += _bn(f"{t}.res_layer.0", f"{o}/res_bn1")
            m.append((f"{t}.res_layer.1.weight", f"{o}/res_conv1/kernel",
                      CONV2))
            m.append((f"{t}.res_layer.2.weight", f"{o}/res_prelu/weight",
                      DIRECT))
            m.append((f"{t}.res_layer.3.weight", f"{o}/res_conv2/kernel",
                      CONV2))
            m += _bn(f"{t}.res_layer.4", f"{o}/res_bn2")
            m.append((f"{t}.res_layer.5.fc1.weight", f"{o}/se/fc1/kernel",
                      CONV2))
            m.append((f"{t}.res_layer.5.fc2.weight", f"{o}/se/fc2/kernel",
                      CONV2))
            i += 1
    m += _bn("output_layer.0", "out_bn2d")
    m += [
        ("output_layer.3.weight", "out_linear/kernel", LINEAR_CF),
        ("output_layer.3.bias", "out_linear/bias", LINEAR),
    ]
    m += _bn("output_layer.4", "out_bn1d")
    return m


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX IRSE50 tree flattened to '/'-joined paths (below 'params') ->
    the IRSE50 state_dict (fp32, CPU; no `num_batches_tracked`). The JAX
    head flattens channels-last: its (7*7*512, 512) kernel, row (h*7 + w)*512
    + c, becomes the torch Linear's (512, 512*7*7), column c*49 + h*7 + w."""
    sd = {}
    for tkey, opath, kind in irse_mapping():
        w = np.asarray(flat[opath], np.float32)
        if kind == LINEAR_CF:
            O = w.shape[1]
            w = w.reshape(7, 7, 512, O).transpose(3, 2, 0, 1).reshape(O, -1)
        else:
            w = _deconvert(kind, opath.rsplit("/", 1)[-1], w)
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


# --------------------------------------------------------------------- #
# descriptor front end


@torch.no_grad()
def face_descriptors(images: np.ndarray, net: IRSE50) -> np.ndarray:
    """(B, H, W, 3) float [0, 1] images -> (B, 512) descriptors.

    The reference IDFeatures front end (id_loss.py:16-23), on the host: resize
    to 256, crop rows 35:223 / cols 32:220 (the face box), pool to 112 (a
    bilinear resize of the 188x188 crop); the network runs on its device.
    """
    from PIL import Image

    crops = []
    for img in images:
        im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        if im.size != (256, 256):
            im = im.resize((256, 256), Image.BILINEAR)
        im = im.crop((32, 35, 220, 223)).resize((112, 112), Image.BILINEAR)
        crops.append(np.asarray(im, np.float32) / 255.0)
    device = next(net.parameters()).device
    x = torch.as_tensor(np.stack(crops), device=device).permute(0, 3, 1, 2).contiguous()
    return net(x * 2.0 - 1.0).float().cpu().numpy()
