"""LPIPS (VGG variant), the learned perceptual metric.

Counterpart of the JAX package's `eval/lpips_vgg.py`. The reference computes
LPIPS with the external `lpips` package (eval/eval_2d_facescape.py:117
`lpips.LPIPS(net='vgg')`); this is the same published formula on the
published weight files: the VGG16 trunk of torchvision (`vgg16-397923af.pth`,
keys `features.N.*`, which load here under the same names) and the LPIPS
linear calibration (`lpips/weights/v0.1/vgg.pth`, keys `linN.model.1.weight`
or `lins.N.model.1.weight`):

  scale inputs by the LPIPS ScalingLayer, run VGG16, take the five relu
  stages (relu1_2/2_2/3_3/4_3/5_3), unit-normalize each channel vector
  (x * rsqrt(sum(x^2) + 1e-10)), square the difference, apply the
  non-negative 1x1 linear per stage, average spatially and sum over stages.

The max-pools of torchvision's trunk sit between the stages only. The
network runs in fp32 on the device its parameters are on.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16 "features" conv indices and widths; the five LPIPS
# stages end after the relu at each closing index
VGG_CONVS: Tuple[Tuple[int, int], ...] = (
    (0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512),
)
STAGE_ENDS = (2, 7, 14, 21, 28)  # conv index whose relu closes each stage
SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


class LPIPSVGG(nn.Module):
    """VGG16 trunk (`features.N`, torchvision's names) and the five
    non-negative per-channel lins (`lins.N`, (C,))."""

    def __init__(self):
        super().__init__()
        self.features = nn.Module()
        cin = 3
        for idx, width in VGG_CONVS:
            self.features.add_module(str(idx), nn.Conv2d(cin, width, 3, padding=1))
            cin = width
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(dict(VGG_CONVS)[i])) for i in STAGE_ENDS])
        self.register_buffer("shift", torch.from_numpy(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(SCALE).view(1, 3, 1, 1), persistent=False)

    def stages(self, x):
        """x: (B, 3, H, W) LPIPS-scaled -> the five relu feature maps."""
        out = []
        h = x
        for idx, _ in VGG_CONVS:
            h = F.relu(getattr(self.features, str(idx))(h))
            if idx in STAGE_ENDS:
                out.append(h)
                if idx == STAGE_ENDS[-1]:
                    break
                # torchvision's pools sit between the stages (indices 4/9/16/23)
                h = F.max_pool2d(h, 2, 2)
        return out

    def forward(self, a, b):
        """a, b: (B, 3, H, W) in [0, 1] -> (B,) LPIPS distances."""
        fa = self.stages((a * 2.0 - 1.0 - self.shift) / self.scale)
        fb = self.stages((b * 2.0 - 1.0 - self.shift) / self.scale)
        total = 0.0
        for lin, ya, yb in zip(self.lins, fa, fb):
            na = ya * torch.rsqrt((ya * ya).sum(1, keepdim=True) + 1e-10)
            nb = yb * torch.rsqrt((yb * yb).sum(1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            total = total + (d * lin.view(1, -1, 1, 1)).sum(1).mean((1, 2))
        return total


@torch.no_grad()
def lpips_distance(a, b, net: LPIPSVGG) -> np.ndarray:
    """a, b: (B, H, W, 3) in [0, 1] (arrays or lists of them) -> (B,) LPIPS
    distances, computed on the device of `net`."""
    device = next(net.parameters()).device
    to = lambda x: torch.as_tensor(np.stack(x).astype(np.float32), device=device).permute(
        0, 3, 1, 2)
    return net(to(a), to(b)).cpu().numpy()


def import_lpips_weights(vgg_sd: Dict[str, np.ndarray], lin_sd: Dict[str, np.ndarray]):
    """(torchvision vgg16 state_dict, lpips vgg.pth state_dict) -> (the
    LPIPSVGG state_dict, report). Accepts the `linN.model.1.weight` and
    `lins.N.model.1.weight` namings for the calibration file; the trunk's
    other keys (torchvision's classifier) are not used."""
    sd = {}
    for idx, width in VGG_CONVS:
        w = np.asarray(vgg_sd[f"features.{idx}.weight"], np.float32)
        if w.shape[0] != width:
            raise ValueError(f"features.{idx}.weight: shape {w.shape}, expected {width} outputs")
        sd[f"features.{idx}.weight"] = torch.from_numpy(w)
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            np.asarray(vgg_sd[f"features.{idx}.bias"], np.float32))
    for s in range(5):
        for key in (f"lin{s}.model.1.weight", f"lins.{s}.model.1.weight"):
            if key in lin_sd:
                w = np.asarray(lin_sd[key], np.float32)  # (1, C, 1, 1)
                sd[f"lins.{s}"] = torch.from_numpy(w.reshape(-1))
                break
        else:
            raise KeyError(f"lpips lin{s} weights not found")
    return sd, {"filled": len(sd)}


def load_lpips(vgg_path: str, lin_path: str, device):
    """Load both weight files -> distance_fn(images_a, images_b) -> (B,), a
    partial of `lpips_distance` (its `keywords["net"]` is the network)."""
    def read(path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        return {k: np.asarray(v) for k, v in sd.get("state_dict", sd).items()}

    sd, report = import_lpips_weights(read(vgg_path), read(lin_path))
    net = LPIPSVGG()
    net.load_state_dict(sd, strict=True)
    net = net.to(device).eval()
    print(f"lpips: {report['filled']} tensors imported")
    return functools.partial(lpips_distance, net=net)
