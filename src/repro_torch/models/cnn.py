"""Paper models for the FL experiments: LeNet-5 and ResNet-9 (Tables 11-12),
plus a small MLP used for CPU-budget experiment runs.

Port of ``repro.models.cnn``.  Each model is an ``nn.Module`` whose
parameters carry the reference's leaf names (``c1``, ``f1.w``, ``b3a.gs``,
``layers.0.b``, ...).  The FL loop never trains a module's own parameters:
it keeps plain ``{name: tensor}`` dicts (stacked ``(K, ...)`` across
clients or clusters) and runs the module through
``torch.func.functional_call``.  :meth:`init_params` draws such a dict
from a seed.

Inputs are flattened feature vectors in the reference's (H, W, C) order.
The convolutions run in NCHW with OIHW weights (the reference's HWIO
weights transpose into them, :func:`repro_torch.convert.cnn_params_from_numpy`);
LeNet-5 permutes back to (H, W, C) before it flattens, so the rows of
``f1.w`` keep the reference's order.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device


class Dense(nn.Module):
    """``x @ w + b`` with the reference's (d_in, d_out) weight layout."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class ConvGN(nn.Module):
    """3x3 ``"SAME"`` convolution, GroupNorm(min(32, C)), ReLU, optional
    2x2 max pool (``_convgn`` of the reference)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.gs = nn.Parameter(torch.ones(cout))
        self.gb = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, pool: bool = False) -> torch.Tensor:
        x = F.conv2d(x, self.w, padding=1)
        # min(32, C) contiguous channel groups, biased variance, eps 1e-5:
        # the reference's _groupnorm
        x = F.relu(F.group_norm(x, min(32, x.shape[1]), self.gs, self.gb, eps=1e-5))
        return F.max_pool2d(x, 2) if pool else x


class FLModel(nn.Module):
    """Base: seeded functional init and the reference's byte accounting."""

    # Bytes of reference leaves that carry no trainable parameter (LeNet-5's
    # ``_meta``); communication totals count them as the reference does.
    meta_bytes = 0

    def init_params(
        self, seed: int, device: DeviceLike = None
    ) -> dict[str, torch.Tensor]:
        """A fresh ``{name: tensor}`` parameter dict drawn from ``seed``.

        The reference's scales: conv weights N(0, 1) / sqrt(kh kw cin),
        dense weights N(0, 1) / sqrt(d_in), biases and GroupNorm shifts 0,
        GroupNorm scales 1.  Draws run on ``device`` (default ``"cuda"``)
        from one generator, in parameter order, so a seed fixes the dict on
        a given device.
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        out = {}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                t = torch.randn(p.shape, generator=gen, device=dev) / math.sqrt(fan_in)
            elif leaf == "w" and p.ndim == 2:
                t = torch.randn(p.shape, generator=gen, device=dev) / math.sqrt(p.shape[0])
            elif leaf == "gs":
                t = torch.ones(p.shape, device=dev)
            else:
                t = torch.zeros(p.shape, device=dev)
            out[name] = t
        return out


class LeNet5(FLModel):
    """conv(6, 5x5) -> pool -> conv(16, 5x5) -> pool -> fc 120 / 84 / out."""

    # The reference's params carry ``_meta = {in_hw: int32 (2,), in_ch:
    # int32 ()}``, 12 bytes that tree_size_bytes counts in every model
    # upload and download.  The port has no such leaf; it adds these bytes.
    meta_bytes = 12

    def __init__(self, *, in_hw=(16, 16), in_ch: int = 3, n_classes: int = 10):
        super().__init__()
        self.in_hw, self.in_ch = tuple(int(s) for s in in_hw), int(in_ch)
        h, w = self.in_hw
        h1, w1 = (h - 4) // 2, (w - 4) // 2
        h2, w2 = (h1 - 4) // 2, (w1 - 4) // 2
        self.c1 = nn.Parameter(torch.empty(6, in_ch, 5, 5))
        self.c2 = nn.Parameter(torch.empty(16, 6, 5, 5))
        self.f1 = Dense(h2 * w2 * 16, 120)
        self.f2 = Dense(120, 84)
        self.f3 = Dense(84, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = x.reshape(B, *self.in_hw, self.in_ch).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(F.conv2d(x, self.c1)), 2)
        x = F.max_pool2d(F.relu(F.conv2d(x, self.c2)), 2)
        # flatten in (H, W, C) order, as the reference's NHWC reshape does
        x = x.permute(0, 2, 3, 1).reshape(B, -1)
        x = F.relu(self.f1(x))
        x = F.relu(self.f2(x))
        return self.f3(x)


class ResNet9(FLModel):
    """ResNet-9 with GroupNorm(32), ending in a global spatial max."""

    def __init__(self, *, in_hw=(16, 16), in_ch: int = 3, n_classes: int = 100):
        super().__init__()
        self.in_hw, self.in_ch = tuple(int(s) for s in in_hw), int(in_ch)
        self.b1 = ConvGN(in_ch, 64)
        self.b2 = ConvGN(64, 128)
        self.b3a = ConvGN(128, 128)
        self.b3b = ConvGN(128, 128)
        self.b4 = ConvGN(128, 256)
        self.b5 = ConvGN(256, 512)
        self.b6a = ConvGN(512, 512)
        self.b6b = ConvGN(512, 512)
        self.fc = Dense(512, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = x.reshape(B, *self.in_hw, self.in_ch).permute(0, 3, 1, 2)
        x = self.b1(x)
        x = self.b2(x, pool=True)
        x = x + self.b3b(self.b3a(x))
        x = self.b4(x, pool=True)
        x = self.b5(x, pool=True)
        x = x + self.b6b(self.b6a(x))
        x = x.amax(dim=(2, 3))
        return self.fc(x)


class MLP(FLModel):
    """Dense layers with ReLU between them (the reference's ``mlp_clf``)."""

    def __init__(self, d_in: int, n_classes: int, hidden=(256, 128)):
        super().__init__()
        dims = (int(d_in),) + tuple(int(h) for h in hidden) + (int(n_classes),)
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


MODEL_ZOO: dict[str, type] = {
    "lenet5": LeNet5,
    "resnet9": ResNet9,
    "mlp": MLP,
}


def build_model(arch: str, *, dim: int, n_classes: int) -> FLModel:
    """The ``arch`` module for flat inputs of ``dim`` features, as the FL
    launcher builds it: the MLP with hidden widths (128, 64); the CNNs on a
    square (hw, hw, 3) image, ``hw = sqrt(dim // 3)``, for both their
    parameters and their forward pass."""
    if arch == "mlp":
        return MLP(dim, n_classes, hidden=(128, 64))
    if arch not in MODEL_ZOO:
        raise ValueError(f"unknown model {arch!r}; have {sorted(MODEL_ZOO)}")
    hw = int((dim // 3) ** 0.5)
    if hw * hw * 3 != dim:
        raise ValueError(f"{arch}: dim {dim} is not a square image of 3 channels")
    return MODEL_ZOO[arch](in_hw=(hw, hw), in_ch=3, n_classes=n_classes)
