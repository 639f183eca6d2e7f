"""RAFT optical flow, and the clip-sliced bidirectional flows of the
propagation path.

Mirror of ``upscale_a_video_tpu/models/raft.py``. The released path uses the
full model ("raft-things": hidden and context widths 128, radius 4, 4
correlation levels, 20 iterations, convex ×8 upsampling); ``small=True``
builds the bottleneck variant (96/64, radius 3, bilinear ×8). No Pallas
kernel serves RAFT, so it runs in plain PyTorch, frozen, in float32.

Modules compute in NCHW, as torch convs and ``raft-things.pth`` expect; their
names are the checkpoint's (``fnet.layer2.0.downsample.0``,
``update_block.mask.2`` ...), so it loads with ``strict=True`` once its
``module.`` prefix is stripped. The cnet's BatchNorm is a frozen
``nn.BatchNorm2d`` in eval mode (running statistics), registered, as in the
checkpoint, both as ``normN`` and inside ``downsample``. The public functions
take and return channels-last tensors: images (B, H, W, 3) in [-1, 1], flows
(B, H, W, 2) in pixels, (x, y) last.

Kept from the JAX package: the correlation lookup adds ``meshgrid(dy, dx)``
to (x, y) unflipped (``docs/PARITY.md:32-33``), which fixes the channel order
of the (2r+1)² samples the trained motion encoder reads; ``resize_flow``
scales x by W'/W and y by H'/H (the intended semantics, not the reference's
dormant indexing bug).
"""

from __future__ import annotations

import dataclasses
from math import ceil
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.resize import resize_2d
from ..weights import init_random_

# ----------------------------------------------------------------- norms


def _norm(kind: str, planes: int) -> nn.Module:
    """The reference's norm choices: frozen BatchNorm (cnet of the full
    model), InstanceNorm without affine (fnet, eps 1e-5), GroupNorm
    (planes / 8 groups, the JAX package's eps), none (small cnet)."""
    if kind == "batch":
        return nn.BatchNorm2d(planes)
    if kind == "instance":
        return nn.InstanceNorm2d(planes)
    if kind == "group":
        return nn.GroupNorm(planes // 8, planes, eps=1e-6)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


# ------------------------------------------------------------- extractor


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1, self.norm2 = _norm(norm_fn, planes), _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride),
                                            self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1):
        super().__init__()
        p4 = planes // 4
        self.conv1 = nn.Conv2d(in_planes, p4, 1)
        self.conv2 = nn.Conv2d(p4, p4, 3, padding=1, stride=stride)
        self.conv3 = nn.Conv2d(p4, planes, 1)
        self.norm1, self.norm2 = _norm(norm_fn, p4), _norm(norm_fn, p4)
        self.norm3 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm4 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride),
                                            self.norm4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class _Encoder(nn.Module):
    """7×7 stride-2 stem, three stages of two blocks (strides 1, 2, 2), 1×1
    head: 3 channels → ``output_dim`` at 1/8 resolution."""

    block = ResidualBlock
    stem, dims = 64, (64, 96, 128)

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, self.stem, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, self.stem)
        cin = self.stem
        for i, (dim, stride) in enumerate(zip(self.dims, (1, 2, 2)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(self.block(cin, dim, norm_fn, stride),
                                                     self.block(dim, dim, norm_fn, 1)))
            cin = dim
        self.conv2 = nn.Conv2d(cin, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicEncoder(_Encoder):
    """The full model's feature and context encoder."""


class SmallEncoder(_Encoder):
    """The small model's encoder: bottleneck blocks of 32/64/96 channels."""

    block = BottleneckBlock
    stem, dims = 32, (32, 64, 96)


# ------------------------------------------------------------ update block


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


def _gru(h, x, convz, convr, convq):
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(convz(hx))
    r = torch.sigmoid(convr(hx))
    q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


class ConvGRU(nn.Module):
    """The small update block's 3×3 GRU."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = nn.Conv2d(cin, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(cin, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(cin, hidden_dim, 3, padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _gru(h, x, self.convz, self.convr, self.convq)


class SepConvGRU(nn.Module):
    """Horizontal (1×5) then vertical (5×1) GRU."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}", nn.Conv2d(cin, hidden_dim, k, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = _gru(h, x, self.convz1, self.convr1, self.convq1)
        return _gru(h, x, self.convz2, self.convr2, self.convq2)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 126, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1))), flow], dim=1)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(planes, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1))), flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 128, context_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        """→ (net, 0.25 · convex-upsampling mask or None, delta flow); the
        mask only with ``with_mask`` (RAFT reads the last iteration's)."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        mask = 0.25 * self.mask(net) if with_mask else None
        return net, mask, self.flow_head(net)


class SmallUpdateBlock(nn.Module):
    """No convex-upsampling mask: the small model upsamples bilinearly."""

    def __init__(self, hidden_dim: int = 96, context_dim: int = 64, corr_levels: int = 4,
                 corr_radius: int = 3):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_levels, corr_radius)
        self.gru = ConvGRU(hidden_dim, context_dim + 82)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)


# ------------------------------------------------------------- correlation


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation pyramid. fmap: (B, C, H, W) → ``num_levels``
    tensors (B·H·W, 1, H/2^i, W/2^i), each level a 2×2 average of the last."""
    b, c, h, w = fmap1.shape
    corr = torch.einsum("bci,bcj->bij", fmap1.reshape(b, c, h * w).float(),
                        fmap2.reshape(b, c, h * w).float()) / c ** 0.5
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def lookup_corr(pyramid: List[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Bilinear (2r+1)² windows around ``coords`` (B, 2, H, W) (level-0
    pixels, x then y) at every level → (B, L·(2r+1)², H, W). The window's
    first (row) index is added to x and its second to y, as the reference
    does (the samples' channel order depends on it)."""
    b, _, h, w = coords.shape
    n = 2 * radius + 1
    lin = torch.linspace(-radius, radius, n, device=coords.device)
    d0, d1 = torch.meshgrid(lin, lin, indexing="ij")
    delta = torch.stack([d0, d1], dim=-1)  # [..., 0] added to x, [..., 1] to y
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        hi, wi = corr.shape[-2:]
        pts = centroid / 2 ** i + delta
        grid = torch.stack([2 * pts[..., 0] / max(wi - 1, 1) - 1,
                            2 * pts[..., 1] / max(hi - 1, 1) - 1], dim=-1)
        sampled = F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True)
        out.append(sampled.reshape(b, h, w, n * n))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ model


class RAFT(nn.Module):
    """Full model by default (hidden and context widths 128, radius 4);
    ``small=True`` the bottleneck variant (96, 64, radius 3). Both read 4
    correlation levels."""

    corr_levels = 4

    def __init__(self, small: bool = False):
        super().__init__()
        self.small = small
        self.hdim, self.cdim, self.radius = (96, 64, 3) if small else (128, 128, 4)
        if small:
            self.fnet = SmallEncoder(128, "instance")
            self.cnet = SmallEncoder(self.hdim + self.cdim, "none")
            self.update_block = SmallUpdateBlock(self.hdim, self.cdim, 4, self.radius)
        else:
            self.fnet = BasicEncoder(256, "instance")
            self.cnet = BasicEncoder(self.hdim + self.cdim, "batch")
            self.update_block = BasicUpdateBlock(self.hdim, self.cdim, 4, self.radius)

    @staticmethod
    def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Convex ×8 upsampling: flow (B, 2, h, w), mask (B, 576, h, w) →
        (B, 2, 8h, 8w); each output pixel a softmax-weighted mix of the 3×3
        neighbourhood of 8·flow (zero padded)."""
        b, _, h, w = flow.shape
        mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
        patches = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
        up = torch.sum(mask * patches, dim=2)  # (B, 2, 8, 8, h, w)
        return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)

    @torch.no_grad()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 20) -> torch.Tensor:
        """image1/2: (B, H, W, 3) in [-1, 1], H and W multiples of 8 →
        flow (B, H, W, 2) from image1 to image2."""
        image1, image2 = (im.float().permute(0, 3, 1, 2) for im in (image1, image2))
        fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels)
        net, inp = torch.split(self.cnet(image1), [self.hdim, self.cdim], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)

        b, _, h8, w8 = fmap1.shape
        yy, xx = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=fmap1.device),
                                torch.arange(w8, dtype=torch.float32, device=fmap1.device),
                                indexing="ij")
        coords0 = torch.stack([xx, yy])[None].expand(b, 2, h8, w8)
        coords1 = coords0
        mask = None
        for it in range(iters):
            corr = lookup_corr(pyramid, coords1, self.radius)
            net, mask, delta = self.update_block(net, inp, corr, coords1 - coords0,
                                                 with_mask=it == iters - 1)
            coords1 = coords1 + delta
        flow = coords1 - coords0
        if self.small:  # bilinear ×8 with magnitudes ×8, align_corners=True
            return 8.0 * resize_2d(flow.permute(0, 2, 3, 1), (8 * h8, 8 * w8), "bilinear",
                                   align_corners=True)
        return self.upsample_flow(flow, mask).permute(0, 2, 3, 1)


# ----------------------------------------------------------- bi wrapper


@dataclasses.dataclass
class RaftRunner:
    """A frozen RAFT and its iteration count: ``runner(i1, i2)`` → flow."""

    model: RAFT
    iters: int = 20

    def __call__(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        return self.model(image1, image2, self.iters)


def load_raft(model_path: Optional[str], iters: int = 20, device=None,
              seed: int = 0) -> RaftRunner:
    """The full RAFT on ``device`` (``cuda`` unless the caller names the CPU), in
    float32 and eval mode: ``model_path`` (``raft-things.pth``, a state dict
    whose keys may carry DataParallel's ``module.`` prefix) loaded with
    ``strict=True``, or, with ``None``, PyTorch's initialisers drawn from a
    generator seeded with ``seed``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = RAFT()
    model = model.to_empty(device=dev)
    if model_path:
        sd = torch.load(model_path, map_location=dev, weights_only=True)
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
        model.load_state_dict(sd, strict=True)
    else:
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        init_random_(model, torch.Generator(device=dev).manual_seed(seed))
    return RaftRunner(model=model.float().eval().requires_grad_(False), iters=iters)


def resize_flow(flow: torch.Tensor, newh: int, neww: int) -> torch.Tensor:
    """Bilinear resize of flows (..., H, W, 2) with x scaled by W'/W and y by
    H'/H."""
    oldh, oldw = flow.shape[-3:-1]
    flow = resize_2d(flow, (newh, neww), "bilinear")
    return flow * torch.tensor([neww / oldw, newh / oldh], dtype=flow.dtype, device=flow.device)


def compute_flow_pair(runner: RaftRunner,
                      frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (B, T, H, W, 3) in [-1, 1] → forward and backward flows
    (B, T-1, H, W, 2); frames are resized to multiples of 8 and the flows
    back."""
    b, t, h, w, _ = frames.shape
    h8, w8 = int(ceil(h / 8) * 8), int(ceil(w / 8) * 8)
    frames8 = resize_2d(frames, (h8, w8), "bilinear") if (h8, w8) != (h, w) else frames
    f1 = frames8[:, :-1].reshape(b * (t - 1), h8, w8, 3)
    f2 = frames8[:, 1:].reshape(b * (t - 1), h8, w8, 3)
    fwd, bwd = runner(f1, f2), runner(f2, f1)
    if (h8, w8) != (h, w):
        fwd, bwd = resize_flow(fwd, h, w), resize_flow(bwd, h, w)
    return fwd.reshape(b, t - 1, h, w, 2), bwd.reshape(b, t - 1, h, w, 2)


def clip_length(width: int) -> int:
    """Frames per flow clip by frame width (≤640 → 12, ≤720 → 8, ≤1280 → 4,
    else 2)."""
    for limit, clip in ((640, 12), (720, 8), (1280, 4)):
        if width <= limit:
            return clip
    return 2


def compute_bidirectional_flows(runner: RaftRunner,
                                frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flows of a clip cut into clips of :func:`clip_length` frames, each
    after the first starting one frame early so that every neighbouring pair
    has its flow."""
    t, clip = frames.shape[1], clip_length(frames.shape[3])
    if t <= clip:
        return compute_flow_pair(runner, frames)
    fs, bs = [], []
    for f in range(0, t, clip):
        ff, bb = compute_flow_pair(runner, frames[:, max(f - 1, 0):min(t, f + clip)])
        fs.append(ff)
        bs.append(bb)
    return torch.cat(fs, dim=1), torch.cat(bs, dim=1)
