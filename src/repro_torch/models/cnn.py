# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The paper's CNN testbed: LeNet-5, CIFAR-scale AlexNet and ResNet-18.

Parameters keep the JAX layouts: HWIO conv kernels and (din, dout) dense
weights, so Eq. 1 scores, mask expansion and Eq. 10 aggregation reduce
over the same axes as the reference and weights carry over unchanged.  The
public functions take NHWC images; the convolutions run in NCHW, and the
activations go back to NHWC order before the flatten in front of ``fc0``
so the rows of ``fc0_w`` line up with the reference.

Helios maskable units are conv filters and dense hidden units; masks
multiply layer OUTPUT channels after the activation, so masked units get
zero gradients.  With ``kernels="cuda"`` (alias ``"pallas"``) every masked
dense layer runs on the block-sparse masked-matmul kernels.  ResNet-18
(GroupNorm in place of BatchNorm, as in the reference) masks conv filters
only, so it has no call site of the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.module import P


def _conv(name, kh, kw, cin, cout):
    return {f"{name}_w": P((kh, kw, cin, cout), (None, None, "embed", "filters")),
            f"{name}_b": P((cout,), ("filters",), init="zeros")}


def _dense(name, din, dout, unit_axis="filters"):
    return {f"{name}_w": P((din, dout), ("embed", unit_axis)),
            f"{name}_b": P((dout,), (unit_axis,), init="zeros")}


def _same_pad(n: int, k: int, stride: int) -> tuple:
    """(before, after) SAME padding of one side: the total
    max((ceil(n/s) - 1)·s + k - n, 0), the smaller half before.  At
    stride 2 on an even side a 3x3 kernel pads 0 before and 1 after."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x, w, b, stride: int = 1):
    """SAME convolution of NCHW ``x`` with an HWIO kernel."""
    if w.shape[0] == w.shape[1] == 1 and stride > 1:
        # a 1x1 kernel at stride s reads every s-th pixel (SAME pads
        # nothing): subsample, then convolve at stride 1.  The strided 1x1
        # weight gradient of PyTorch's CPU backend crashes on the
        # channels-last activations the NHWC input leaves behind.
        x, stride = x[:, :, ::stride, ::stride], 1
    (top, bottom), (left, right) = (
        _same_pad(x.shape[2], w.shape[0], stride),
        _same_pad(x.shape[3], w.shape[1], stride))
    w = w.permute(3, 2, 0, 1)
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride)


def _groups(c: int, groups: int = 8) -> int:
    """min(groups, c), decremented until it divides c (12 -> 6)."""
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def group_norm(x, groups: int = 8, eps: float = 1e-5):
    """GroupNorm of NCHW ``x`` without affine, over groups of consecutive
    channels, in the reference's arithmetic: the mean, then the biased
    variance of the centred values, then rsqrt.  (``F.group_norm`` sums
    another way; on a group of one channel with a small variance the
    difference grows along a trajectory past 1e-5 within four local
    steps.)"""
    n, c, h, w = x.shape
    g = _groups(c, groups)
    xg = x.reshape(n, g, c // g, h, w)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mu).square().mean(dim=(2, 3, 4), keepdim=True)
    return ((xg - mu) * torch.rsqrt(var + eps)).reshape(n, c, h, w)


def avg_pool(x, k: int = 2):
    """VALID k x k average pooling at stride k."""
    return F.avg_pool2d(x, k)


def _m(masks, key) -> Optional[torch.Tensor]:
    if masks is None or key not in masks:
        return None
    v = masks[key]
    return v[0] if v.dim() == 2 else v


def _apply_channels(x, mask):
    """Mask the channel dim of an NCHW activation."""
    return x if mask is None else x * mask.view(1, -1, 1, 1)


def _fc(params, x, name, masks, kernels, mask_block, act):
    """One maskable dense layer: act(x @ W + b) · mask.  With the CUDA
    kernels the product runs block-sparse (dead column blocks skipped in
    forward and backward); the output mask still multiplies the activation,
    so the numbers match the reference path."""
    m = _m(masks, name)
    w, b = params[f"{name}_w"], params[f"{name}_b"]
    if kernels is not None and ops.canonical_impl(kernels) == ops.CUDA \
            and m is not None:
        z = ops.masked_dense(x, w, m, impl=ops.CUDA, block_n=mask_block)
    else:
        z = x @ w
    y = act(z + b)
    return y if m is None else y * m


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# LeNet-5
# ---------------------------------------------------------------------------


def lenet_spec(cfg: ModelConfig):
    c1, c2 = cfg.cnn_channels
    side = cfg.image_size // 4
    return {**_conv("conv0", 5, 5, cfg.in_channels, c1),
            **_conv("conv1", 5, 5, c1, c2),
            **_dense("fc0", side * side * c2, 120),
            **_dense("fc1", 120, 84),
            **_dense("head", 84, cfg.num_classes, unit_axis=None)}


def lenet_mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    c1, c2 = cfg.cnn_channels
    return {"conv0": (1, c1), "conv1": (1, c2), "fc0": (1, 120), "fc1": (1, 84)}


def lenet_fwd(params, x, cfg, masks=None, kernels=None, mask_block=128):
    x = torch.tanh(conv2d(x, params["conv0_w"], params["conv0_b"]))
    x = F.avg_pool2d(_apply_channels(x, _m(masks, "conv0")), 2)
    x = torch.tanh(conv2d(x, params["conv1_w"], params["conv1_b"]))
    x = F.avg_pool2d(_apply_channels(x, _m(masks, "conv1")), 2)
    x = _flatten_nhwc(x)
    x = _fc(params, x, "fc0", masks, kernels, mask_block, torch.tanh)
    x = _fc(params, x, "fc1", masks, kernels, mask_block, torch.tanh)
    return x @ params["head_w"] + params["head_b"]


# ---------------------------------------------------------------------------
# AlexNet (CIFAR-scale)
# ---------------------------------------------------------------------------


def alexnet_spec(cfg: ModelConfig):
    cs = cfg.cnn_channels
    spec = {}
    cin = cfg.in_channels
    for i, c in enumerate(cs):
        spec.update(_conv(f"conv{i}", 3, 3, cin, c))
        cin = c
    side = cfg.image_size // 8
    spec.update(_dense("fc0", side * side * cs[-1], 1024))
    spec.update(_dense("fc1", 1024, 512))
    spec.update(_dense("head", 512, cfg.num_classes, unit_axis=None))
    return spec


def alexnet_mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    out = {f"conv{i}": (1, c) for i, c in enumerate(cfg.cnn_channels)}
    out.update({"fc0": (1, 1024), "fc1": (1, 512)})
    return out


def alexnet_fwd(params, x, cfg, masks=None, kernels=None, mask_block=128):
    cs = cfg.cnn_channels
    pool_after = {0, 1, len(cs) - 1}
    for i in range(len(cs)):
        x = torch.relu(conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"]))
        x = _apply_channels(x, _m(masks, f"conv{i}"))
        if i in pool_after:
            x = F.max_pool2d(x, 2)          # VALID 2x2 / 2
    x = _flatten_nhwc(x)
    x = _fc(params, x, "fc0", masks, kernels, mask_block, torch.relu)
    x = _fc(params, x, "fc1", masks, kernels, mask_block, torch.relu)
    return x @ params["head_w"] + params["head_b"]


# ---------------------------------------------------------------------------
# ResNet-18 (GroupNorm)
# ---------------------------------------------------------------------------


def resnet18_spec(cfg: ModelConfig):
    ws = cfg.cnn_channels                     # (64, 128, 256, 512)
    spec = {**_conv("stem", 3, 3, cfg.in_channels, ws[0])}
    cin = ws[0]
    for s, w in enumerate(ws):
        for b in range(2):
            spec.update(_conv(f"s{s}b{b}c0", 3, 3, cin if b == 0 else w, w))
            spec.update(_conv(f"s{s}b{b}c1", 3, 3, w, w))
            if b == 0 and cin != w:
                spec.update(_conv(f"s{s}proj", 1, 1, cin, w))
        cin = w
    spec.update(_dense("head", ws[-1], cfg.num_classes, unit_axis=None))
    return spec


def resnet18_mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    """The first conv of each block is maskable (its filters)."""
    return {f"s{s}b{b}c0": (1, w) for s, w in enumerate(cfg.cnn_channels)
            for b in range(2)}


def resnet18_fwd(params, x, cfg, masks=None, kernels=None, mask_block=128):
    # the maskable units are conv filters only: the masked dense kernels
    # have no call site here; ``kernels`` is taken for dispatch uniformity
    ws = cfg.cnn_channels
    x = torch.relu(group_norm(conv2d(x, params["stem_w"], params["stem_b"])))
    cin = ws[0]
    for s, w in enumerate(ws):
        for b in range(2):
            stride = 2 if (b == 0 and s > 0) else 1
            h = conv2d(x, params[f"s{s}b{b}c0_w"], params[f"s{s}b{b}c0_b"],
                       stride=stride)
            h = torch.relu(group_norm(h))
            h = _apply_channels(h, _m(masks, f"s{s}b{b}c0"))
            h = conv2d(h, params[f"s{s}b{b}c1_w"], params[f"s{s}b{b}c1_b"])
            h = group_norm(h)
            if b == 0 and cin != w:
                x = conv2d(x, params[f"s{s}proj_w"], params[f"s{s}proj_b"],
                           stride=stride)
            elif stride != 1:
                x = avg_pool(x, stride)
            x = torch.relu(x + h)
        cin = w
    x = x.mean(dim=(2, 3))
    return x @ params["head_w"] + params["head_b"]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_SPECS = {"lenet": lenet_spec, "alexnet": alexnet_spec,
          "resnet18": resnet18_spec}
_FWDS = {"lenet": lenet_fwd, "alexnet": alexnet_fwd, "resnet18": resnet18_fwd}
_SCHEMAS = {"lenet": lenet_mask_schema, "alexnet": alexnet_mask_schema,
            "resnet18": resnet18_mask_schema}


def _lookup(table, cfg):
    try:
        return table[cfg.name]
    except KeyError:
        raise ValueError(f"unknown CNN {cfg.name!r} (the testbed has "
                         f"{sorted(table)})") from None


def cnn_spec(cfg: ModelConfig):
    return _lookup(_SPECS, cfg)(cfg)


def cnn_mask_schema(cfg: ModelConfig):
    return _lookup(_SCHEMAS, cfg)(cfg)


def cnn_logits(params, images, cfg, masks=None, kernels=None, mask_block=128):
    """NHWC images -> logits."""
    x = images.permute(0, 3, 1, 2)
    return _lookup(_FWDS, cfg)(params, x, cfg, masks, kernels, mask_block)


def cnn_loss(params, batch, cfg, rt=None, masks=None):
    rt = rt or {}
    logits = cnn_logits(params, batch["images"], cfg, masks,
                        kernels=rt.get("kernels"),
                        mask_block=rt.get("mask_block", 128))
    return F.cross_entropy(logits, batch["labels"].long())

