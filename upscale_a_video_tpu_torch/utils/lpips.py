"""LPIPS, the learned perceptual distance of the eval gate (Zhang et al.),
with its AlexNet and VGG16 backbones.

Port of ``upscale_a_video_tpu/utils/lpips.py``. The module's parameters
carry the ``lpips`` package's own state-dict names, so its checkpoints load
with no conversion step:
- ``net.slice{k}.{i}.{weight,bias}``: torchvision's ``features`` convs,
  grouped into the five slices that end at the five taps, under their
  torchvision indices;
- ``lin{k}.model.1.weight``: the non-negative 1 x 1 "lin" convs, (1, C, 1, 1);
- ``scaling_layer.{shift,scale}``: the input scaling, constants (a
  checkpoint may leave them out).
The JAX package reads the same checkpoint through ``convert_lpips_state``.
Inputs are (B, H, W, 3) RGB in [-1, 1], channels-last as in JAX; the
distance is JAX's: unit-normalised taps (x * rsqrt(sum x^2 + 1e-10)), the
lin-weighted squared difference, its spatial mean, summed over the taps.
The weights are not in the repository: every check runs on random ones.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

# lpips ScalingLayer constants (lpips/lpips.py)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
CHANNELS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512)}
# torchvision ``features`` index ranges of the five slices
_ALEX_SLICES = ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))
_VGG_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


def _alex_features() -> List[nn.Module]:
    """torchvision AlexNet.features up to its last ReLU."""
    return [nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU()]


def _vgg16_features() -> List[nn.Module]:
    """torchvision VGG16.features up to relu5_3."""
    layers, cin = [], 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512):
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
            cin = v
    return layers


def _slices(features: Sequence[nn.Module], ranges: Tuple[Tuple[int, int], ...]) -> nn.Module:
    net = nn.Module()
    for k, (a, b) in enumerate(ranges, start=1):
        seq = nn.Sequential()
        for i in range(a, b):
            seq.add_module(str(i), features[i])
        net.add_module(f"slice{k}", seq)
    return net


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """A lin layer: the package's dropout (index 0, an identity at
    inference) and a 1 x 1 conv without bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """``LPIPS(net)(a, b)`` → (B,): the distance of each pair of frames."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in CHANNELS:
            raise ValueError(f"LPIPS net {net!r}: 'alex' or 'vgg'")
        self.scaling_layer = ScalingLayer()
        self.net = (_slices(_alex_features(), _ALEX_SLICES) if net == "alex"
                    else _slices(_vgg16_features(), _VGG_SLICES))
        for k, c in enumerate(CHANNELS[net]):
            self.add_module(f"lin{k}", NetLinLayer(c))

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The five feature maps of (B, H, W, 3) frames, channels first."""
        x = self.scaling_layer(x.float().permute(0, 3, 1, 2))
        out = []
        for k in range(1, 6):
            x = getattr(self.net, f"slice{k}")(x)
            out.append(x)
        return out

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for k, (xa, xb) in enumerate(zip(self.taps(a), self.taps(b))):
            na = xa * torch.rsqrt(xa.square().sum(dim=1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt(xb.square().sum(dim=1, keepdim=True) + 1e-10)
            d = getattr(self, f"lin{k}").model((na - nb).square())
            total = total + d.mean(dim=(1, 2, 3))
        return total


def load_lpips(path: str, net: str = "alex", device=None) -> LPIPS:
    """The metric from an ``lpips`` package checkpoint on disk (its own key
    names, read with ``torch.load(weights_only=True)``), in eval mode on
    ``device`` (the CPU unless named). Raises ``KeyError`` for a missing
    backbone or lin weight; the scaling constants may be absent."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model = LPIPS(net)
    missing = [k for k in model.state_dict() if k not in state
               and not k.startswith("scaling_layer.")]
    if missing:
        raise KeyError(f"LPIPS checkpoint {path} lacks {missing}")
    model.load_state_dict(state, strict=False)
    return model.to(device or "cpu").eval()
