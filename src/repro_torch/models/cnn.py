"""Small ResNet-family CNN of the paper-faithful SigmaQuant runs (port of
``repro/models/cnn.py``).

The paper validates on ResNet/CIFAR-100; this reduced ResNet trains on the
teacher-labelled image task (``data/images.py``) and runs the two-phase
controller (``quant.env.CNNQuantEnv``).  Activations stay NHWC and weights
HWIO, as in the JAX package, so parameters carry across unchanged and the
per-output-channel axis stays last; only ``F.conv2d`` sees NCHW / OIHW.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.policy import LayerInfo
from repro_torch.device import resolve_device
from repro_torch.kernels.fake_quant.ops import fake_quant_ste


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet_mini"
    in_channels: int = 3
    img_size: int = 16
    stages: tuple[tuple[int, int], ...] = ((16, 1), (32, 1), (64, 1))  # (width, blocks)
    n_classes: int = 20
    dtype: str = "float32"


def _conv_init(gen, k, cin, cout, device):
    fan_in = k * k * cin
    return torch.randn((k, k, cin, cout), generator=gen, device=device) * math.sqrt(2.0 / fan_in)


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: at stride 2 on an even size a 3-wide
    kernel pads 0 before and 1 after."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w, "SAME" padding -> NHWC."""
    k_h, k_w = w.shape[:2]
    top, bottom = _same_pad(x.shape[1], k_h, stride)
    left, right = _same_pad(x.shape[2], k_w, stride)
    xc = x.permute(0, 3, 1, 2)
    if top or bottom or left or right:
        xc = F.pad(xc, (left, right, top, bottom))
    return F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def block_strides(cfg: CNNConfig) -> tuple[int, ...]:
    """Stride of each residual block (2 at each stage-entry downsample)."""
    strides, cin = [], cfg.stages[0][0]
    for width, n_blocks in cfg.stages:
        for b in range(n_blocks):
            strides.append(2 if (b == 0 and width != cin) else 1)
            cin = width
    return tuple(strides)


def init(cfg: CNNConfig, generator: torch.Generator | None = None, device=None) -> dict:
    """Random params made on ``device`` (default ``cuda``), drawn from
    ``generator`` (default: seed 0 on ``device``)."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    params: dict = {"stem": _conv_init(gen, 3, cfg.in_channels, cfg.stages[0][0], device)}
    cin = cfg.stages[0][0]
    blocks = []
    for width, n_blocks in cfg.stages:
        for b in range(n_blocks):
            stride = 2 if (b == 0 and width != cin) else 1
            blk = {"conv1": _conv_init(gen, 3, cin, width, device),
                   "conv2": _conv_init(gen, 3, width, width, device),
                   "scale1": torch.ones(width, device=device),
                   "scale2": torch.ones(width, device=device)}
            if stride != 1 or cin != width:
                blk["proj"] = _conv_init(gen, 1, cin, width, device)
            blocks.append(blk)
            cin = width
    params["blocks"] = blocks
    params["fc"] = (torch.randn((cin, cfg.n_classes), generator=gen, device=device)
                    * math.sqrt(1.0 / cin))
    return params


def _maybe_fq(w: torch.Tensor, bits):
    # "auto": row 10's kernel on a CUDA tensor (an HWIO weight is (H*W*I) x O
    # rows), the plain version on the CPU
    return w if bits is None else fake_quant_ste(w, bits, "auto")


def _norm_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # the population variance written out as ``jnp.var`` computes it: the
    # backward of ``torch.var(correction=0)`` in f32 lost up to 1.2e-2 (rel)
    # of block 2's conv gradients under a 2-bit mixed policy, where this form
    # stays within 2e-6 of an f64 evaluation
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(0, 1, 2), keepdim=True) + 1e-5
    return torch.relu((x - mu) * torch.rsqrt(var) * scale)


def forward(params: dict, x: torch.Tensor, cfg: CNNConfig, *, bits: dict | None = None
            ) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes).  bits: name -> float."""

    def b(name):
        return None if bits is None else bits.get(name)

    h = torch.relu(conv(_maybe_fq(params["stem"], b("stem")), x))
    for i, (blk, stride) in enumerate(zip(params["blocks"], block_strides(cfg))):
        y = conv(_maybe_fq(blk["conv1"], b(f"block{i}.conv1")), h, stride)
        y = _norm_act(y, blk["scale1"])
        y = conv(_maybe_fq(blk["conv2"], b(f"block{i}.conv2")), y)
        y = _norm_act(y, blk["scale2"])
        if "proj" in blk:
            h = conv(_maybe_fq(blk["proj"], b(f"block{i}.proj")), h, stride)
        h = h + y
    pooled = torch.mean(h, dim=(1, 2))
    return pooled @ _maybe_fq(params["fc"], b("fc"))


def quant_layer_specs(params: dict, cfg: CNNConfig) -> tuple[LayerInfo, ...]:
    """A LayerInfo per quantizable conv/fc, with per-sample MACs."""
    hw = cfg.img_size
    infos = [LayerInfo("stem", tuple(params["stem"].shape),
                       macs=9 * cfg.in_channels * cfg.stages[0][0] * hw * hw, kind="conv")]
    for i, (blk, stride) in enumerate(zip(params["blocks"], block_strides(cfg))):
        if stride == 2:
            hw //= 2
        for leaf, taps in (("conv1", 9), ("conv2", 9), ("proj", 1)):
            if leaf in blk:
                k = tuple(blk[leaf].shape)
                infos.append(LayerInfo(f"block{i}.{leaf}", k,
                                       macs=int(taps * k[2] * k[3] * hw * hw), kind="conv"))
    fc = tuple(params["fc"].shape)
    infos.append(LayerInfo("fc", fc, macs=int(fc[0] * fc[1]), kind="dense"))
    return tuple(infos)


def get_weight(params: dict, name: str) -> torch.Tensor:
    if name in ("stem", "fc"):
        return params[name]
    blk, leaf = name.split(".")
    return params["blocks"][int(blk[5:])][leaf]
