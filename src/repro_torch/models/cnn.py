"""The paper's CNN workloads: LeNet-5, AlexNet, VGG-16 ConvL stacks.

Each network is a list of conv-layer geometries (the paper's experiments
time only the ConvLs).  ``run_convls`` runs the stack single-node (the
uncoded reference) or, given a plan, through a ``CodedPipeline``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.fcdcc import FcdccPlan
from ..core.partition import ConvGeometry
from ..core.pipeline import CodedPipeline, plan_layers, relu_pool
from ..devices import resolve_device

__all__ = ["ConvL", "CNN_SPECS", "SMOKE_HW", "input_hw", "layer_geometry",
           "init_cnn", "params_from_numpy", "run_convls"]


@dataclasses.dataclass(frozen=True)
class ConvL:
    name: str
    in_ch: int
    out_ch: int
    kernel: int
    stride: int = 1
    padding: int = 0
    pool: int = 1  # max-pool factor applied after relu


# (input spatial size, conv layer list) — the published configurations
LENET5 = (
    32,
    [
        ConvL("conv1", 1, 6, 5),
        ConvL("conv2", 6, 16, 5, pool=2),
    ],
)

ALEXNET = (
    227,
    [
        ConvL("conv1", 3, 96, 11, stride=4, pool=2),
        ConvL("conv2", 96, 256, 5, padding=2, pool=2),
        ConvL("conv3", 256, 384, 3, padding=1),
        ConvL("conv4", 384, 384, 3, padding=1),
        ConvL("conv5", 384, 256, 3, padding=1, pool=2),
    ],
)

VGG16 = (
    224,
    [
        ConvL("conv1_1", 3, 64, 3, padding=1),
        ConvL("conv1_2", 64, 64, 3, padding=1, pool=2),
        ConvL("conv2_1", 64, 128, 3, padding=1),
        ConvL("conv2_2", 128, 128, 3, padding=1, pool=2),
        ConvL("conv3_1", 128, 256, 3, padding=1),
        ConvL("conv3_2", 256, 256, 3, padding=1),
        ConvL("conv3_3", 256, 256, 3, padding=1, pool=2),
        ConvL("conv4_1", 256, 512, 3, padding=1),
        ConvL("conv4_2", 512, 512, 3, padding=1),
        ConvL("conv4_3", 512, 512, 3, padding=1, pool=2),
        ConvL("conv5_1", 512, 512, 3, padding=1),
        ConvL("conv5_2", 512, 512, 3, padding=1),
        ConvL("conv5_3", 512, 512, 3, padding=1, pool=2),
    ],
)

CNN_SPECS = {"lenet5": LENET5, "alexnet": ALEXNET, "vgg16": VGG16}

# reduced spatial sizes for CPU smoke runs
SMOKE_HW = {"lenet5": 32, "alexnet": 113, "vgg16": 56}


def input_hw(name: str, smoke: bool = False) -> int:
    """Canonical input resolution of a named CNN (``smoke`` shrinks it)."""
    return SMOKE_HW[name] if smoke else CNN_SPECS[name][0]


def layer_geometry(layer: ConvL, hw: int, k_a: int = 1, k_b: int = 1) -> ConvGeometry:
    return ConvGeometry(
        in_channels=layer.in_ch, out_channels=layer.out_ch, height=hw,
        width=hw, kernel_h=layer.kernel, kernel_w=layer.kernel,
        stride=layer.stride, padding=layer.padding, k_a=k_a, k_b=k_b,
    )


def init_cnn(name: str, generator: torch.Generator,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Random OIHW filters scaled by 1/sqrt(fan-in), drawn from
    ``generator`` on the CPU (so a seed gives the same weights on every
    device) and moved to ``device``."""
    dev = resolve_device(device)
    _, layers = CNN_SPECS[name]
    return {
        l.name: (torch.randn((l.out_ch, l.in_ch, l.kernel, l.kernel),
                             generator=generator, dtype=dtype)
                 * (1.0 / (l.in_ch * l.kernel**2) ** 0.5)).to(dev)
        for l in layers
    }


def params_from_numpy(params: dict[str, np.ndarray],
                      device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Carry weights made elsewhere (e.g. the JAX package's ``init_cnn``,
    as numpy) across unchanged: same OIHW layout, same values."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=dev) for k, v in params.items()}


def run_convls(name: str, params: dict, x: torch.Tensor, *,
               plan: FcdccPlan | None = None, per_layer_kab: dict | None = None,
               worker_ids=None, backend: str = "kernel") -> torch.Tensor:
    """Run the ConvL stack on one image (C,H,W) or a batch (B,C,H,W), on
    ``x``'s device.

    ``plan=None`` is the uncoded single-node reference: ``F.conv2d`` with
    TF32 off on the card, so it holds the coded path to full fp32.
    Otherwise the stack is compiled into a ``CodedPipeline`` with (k_a, k_b)
    from ``per_layer_kab`` (falling back to the plan's); ``worker_ids`` are
    the available workers.
    """
    _, layers = CNN_SPECS[name]
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if plan is None:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            assert not torch.backends.cudnn.allow_tf32
            for layer in layers:
                y = F.conv2d(x, params[layer.name], stride=layer.stride,
                             padding=layer.padding)
                x = relu_pool(y, layer.pool)
    else:
        specs = plan_layers(layers, x.shape[-1], plan.n,
                            default_kab=(plan.k_a, plan.k_b),
                            per_layer_kab=per_layer_kab)
        pipe = CodedPipeline(specs, params, backend=backend, device=x.device)
        x = pipe.run(x, worker_ids)
    return x[0] if squeeze else x
