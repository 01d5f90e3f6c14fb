"""The in-repo 68-landmark detector, the keypoint backend for PCK.

Counterpart of the JAX package's `eval/keypoint_net.py`. The reference's
keypoint stage shells out to mmdet (YOLOX face detector) + mmpose (HRNetV2
top-down) model zoos (eval/predict_keypoints.py); this compact heatmap
network replaces them: a strided conv encoder with residual blocks and two
transposed convs producing 68 heatmaps at 1/4 resolution, decoded with a
soft-argmax (fp32). It is trained from scratch with `apps/train_keypoints.py`
and drives `apps/eval_keypoints.py --backend native`.

Numerics kept from the flax module: 'SAME' padding (asymmetric for the
strided convs: `_SameConv2d`), every GroupNorm 8 groups with flax's eps
1e-6 and SiLU (the port's `layers.GroupNorm`, K4 on the card), and the
transposed convs as flax's `ConvTranspose((4, 4), strides 2)`: its kernel
flipped in both spatial axes under `F.conv_transpose2d(stride=2,
padding=1)`. The modules carry the flax auto-names (`Conv_0`,
`ResBlock_N.GroupNorm_0`, `ConvTranspose_0`, ...), so a JAX tree carries
across by `from_jax_params`. The second head norm (`GroupNorm_1`) applies
no activation itself: its output, before SiLU, is the appearance feature
that `apps/calibrate_reid.py --embedder landmark` pools (`LandmarkNet.trunk`).

Weights are the port's own `.pt` ({"num_keypoints", "state_dict"}) or the
JAX package's flax-msgpack file ({"num_keypoints", "params": {"params":
tree}}, such as the shipped `artifacts/landmark_net_synth.msgpack`), read
without flax by `utils/flax_msgpack.py` and carried over by
`from_jax_params`; `load_params` tells them apart by content.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch import weights
from morphablediffusion_torch.models.layers import GroupNorm
from morphablediffusion_torch.utils import flax_msgpack

GN_GROUPS, GN_EPS = 8, 1e-6  # flax nn.GroupNorm's defaults


class _SameConv2d(nn.Conv2d):
    """flax nn.Conv with 'SAME' padding: the total pad max((ceil(n/s) - 1)*s
    + k - n, 0) of each spatial dim, the smaller half before."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, s)


def _norm(ch: int, act="silu"):
    return GroupNorm(GN_GROUPS, ch, epsilon=GN_EPS, act=act)


class ResBlock(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.GroupNorm_0 = _norm(cin)
        self.Conv_0 = _SameConv2d(cin, ch, 3, stride)
        self.GroupNorm_1 = _norm(ch)
        self.Conv_1 = _SameConv2d(ch, ch, 3)
        self.Conv_2 = _SameConv2d(cin, ch, 1, stride) if (cin != ch or stride != 1) else None

    def forward(self, x):
        h = self.Conv_0(self.GroupNorm_0(x))
        h = self.Conv_1(self.GroupNorm_1(h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return x + h


class LandmarkNet(nn.Module):
    """(B, 3, S, S) in [0, 1] -> ((B, K, 2) pixel coords (x, y), (B, K, h, w)
    heatmaps, h = S // 4)."""

    def __init__(self, num_keypoints: int = 68, widths: Tuple[int, ...] = (32, 64, 128, 256)):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.Conv_0 = _SameConv2d(3, widths[0], 7, 2)
        cin, i = widths[0], 0
        for w in widths[1:]:
            for stride in (2, 1):
                self.add_module(f"ResBlock_{i}", ResBlock(cin, w, stride))
                cin, i = w, i + 1
        self.n_blocks = i
        # S/16 -> S/4 with two transposed convs, each flax's
        # ConvTranspose((4, 4), strides 2, 'SAME'): exactly 2x
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, widths[2], 4, stride=2, padding=1)
        self.GroupNorm_0 = _norm(widths[2])
        self.ConvTranspose_1 = nn.ConvTranspose2d(widths[2], widths[1], 4, stride=2, padding=1)
        self.GroupNorm_1 = _norm(widths[1], act=None)
        self.Conv_1 = nn.Conv2d(widths[1], num_keypoints, 1)

    def trunk(self, x):
        """The head's last GroupNorm output, before its SiLU: (B, C, h, w)."""
        h = self.Conv_0(x * 2.0 - 1.0)
        for i in range(self.n_blocks):
            h = getattr(self, f"ResBlock_{i}")(h)
        h = self.GroupNorm_0(self.ConvTranspose_0(h))
        return self.GroupNorm_1(self.ConvTranspose_1(h))

    def forward(self, x):
        maps = self.Conv_1(F.silu(self.trunk(x)))  # (B, K, S/4, S/4)
        coords = soft_argmax(maps) * (x.shape[2] / maps.shape[-1])
        return coords, maps


def soft_argmax(maps, temperature: float = 1.0):
    """(B, K, h, w) -> (B, K, 2) expected (x, y) in heatmap pixels, in fp32."""
    B, K, h, w = maps.shape
    p = torch.softmax(maps.reshape(B, K, h * w).float() / temperature, dim=-1)
    grid_x = torch.arange(w, dtype=p.dtype, device=p.device).repeat(h)
    grid_y = torch.arange(h, dtype=p.dtype, device=p.device).repeat_interleave(w)
    return torch.stack([p @ grid_x, p @ grid_y], dim=-1)


def keypoint_loss(net: LandmarkNet, images, kpts):
    """Soft-argmax L2 in image pixels, normalized by image size; images
    (B, 3, S, S), kpts (B, K, 2)."""
    coords, _ = net(images)
    S = images.shape[2]
    return torch.mean(torch.sum(((coords - kpts) / S) ** 2, dim=-1))


def seeded_net(seed: int = 0, num_keypoints: int = 68) -> LandmarkNet:
    """LandmarkNet at PyTorch's default initialization, drawn under `seed`
    (the global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return LandmarkNet(num_keypoints)


_TRANSPOSED = re.compile(r"^ConvTranspose_\d+/kernel$")


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX LandmarkNet tree flattened to '/'-joined paths (below 'params')
    -> the LandmarkNet state_dict (fp32, CPU). A ConvTranspose kernel (kh,
    kw, I, O) becomes (I, O, kh, kw), flipped in both spatial axes."""
    sd = weights.from_jax_params(
        {k: v for k, v in flat.items() if not _TRANSPOSED.match(k)}, device="cpu")
    for k, v in flat.items():
        if _TRANSPOSED.match(k):
            w = np.asarray(v, np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
            sd[k.replace("/kernel", ".weight")] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


def save_params(path, net: LandmarkNet):
    torch.save({"num_keypoints": net.num_keypoints,
                "state_dict": {k: v.detach().cpu() for k, v in net.state_dict().items()}}, path)


def load_params(path, device) -> LandmarkNet:
    """A LandmarkNet on `device` from the port's `.pt` (`save_params`) or
    the JAX package's flax-msgpack file, told apart by content (a torch zip
    starts `PK\\x03\\x04`), not by suffix. A file that is neither raises."""
    if flax_msgpack.is_torch_file(path):
        state = torch.load(path, map_location="cpu", weights_only=True)
        num, sd = state["num_keypoints"], state["state_dict"]
    else:
        blob = flax_msgpack.restore(path)
        num = int(blob["num_keypoints"])
        sd = from_jax_params(flax_msgpack.flatten(blob["params"]["params"]))
    net = LandmarkNet(num)
    net.load_state_dict(sd, strict=True)
    return net.to(device).eval()


@torch.no_grad()
def detect(net: LandmarkNet, images: np.ndarray, chunk: int = 8) -> np.ndarray:
    """(N, S, S, 3) [0, 1] -> (N, K, 2) pixel keypoints, on the net's device."""
    device = next(net.parameters()).device
    out = []
    for lo in range(0, len(images), chunk):
        x = torch.as_tensor(np.asarray(images[lo : lo + chunk], np.float32), device=device)
        out.append(net(x.permute(0, 3, 1, 2).contiguous())[0].cpu().numpy())
    return np.concatenate(out)
