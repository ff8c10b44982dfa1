"""nnU-Net v2's ``PlainConvUNet``, the 3-D segmentation network that
TotalSegmentator runs on every patient of the masking workflow, in PyTorch.

The module tree is that of ``dynamic_network_architectures``
(``architectures/unet.py`` ``PlainConvUNet``, ``building_blocks/
plain_conv_encoder.py``, ``unet_decoder.py``, ``simple_conv_blocks.py``),
so the ``network_weights`` of an nnU-Net ``checkpoint_final.pth`` load
strictly, the keys that name one module twice included:

  encoder.stages.{s}.0.convs.{i}.conv.{weight,bias}     3x3x3 conv, bias
  encoder.stages.{s}.0.convs.{i}.norm.{weight,bias}     InstanceNorm3d, affine
  encoder.stages.{s}.0.convs.{i}.all_modules.{0,1}.*    the same two modules
  decoder.encoder.*                                     the encoder again
  decoder.transpconvs.{s}.{weight,bias}                 ConvTranspose3d
  decoder.stages.{s}.convs.{i}.*                        as the encoder's
  decoder.seg_layers.{s}.{weight,bias}                  1x1x1 conv to classes

The encoder's first conv of each stage takes the stage's stride; every
conv is followed by InstanceNorm (eps 1e-5, affine) and LeakyReLU(0.01).
The decoder upsamples by the transposed conv, concatenates ``[up, skip]``,
and runs the stage's convs; at inference only the last ``seg_layers`` conv
runs (no deep supervision). ``canonical_key`` maps each key to the one
key a parameter has (the encoder's, ``conv``/``norm``); the benchmark's
seeded weights and the plain reference use those.

Layout and numerics: the convs are ``F.conv3d`` / ``F.conv_transpose3d``
(cuDNN on the card) on channels-last-3d tensors in the compute dtype
(``for_inference`` casts the conv weights, the norms' affine stays fp32);
every norm with its LeakyReLU is K2's 3-D route
(``ops/kernels/instance_norm.instance_norm3d``) on the NDHWC view of the
conv's output, its plain version on the CPU.

``load_nnunet(directory)`` reads a trained model as nnU-Net writes it
(``plans.json``, ``dataset.json``, ``fold_*/checkpoint_final.pth``) and
returns the network and its plan (``plan_from_nnunet``).
"""
from __future__ import annotations

import glob
import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from ducosy_tpu_torch.ops.kernels.instance_norm import instance_norm3d

EPS = 1e-5
NEGATIVE_SLOPE = 0.01


class ConvDropoutNormReLU(nn.Module):
    """conv -> InstanceNorm -> LeakyReLU (no dropout in nnU-Net's plans)."""

    def __init__(self, cin: int, cout: int, kernel, stride):
        super().__init__()
        kernel, stride = tuple(kernel), tuple(stride)
        self.conv = nn.Conv3d(cin, cout, kernel, stride,
                              padding=[(k - 1) // 2 for k in kernel],
                              bias=True)
        self.norm = nn.InstanceNorm3d(cout, eps=EPS, affine=True)
        self.nonlin = nn.LeakyReLU(NEGATIVE_SLOPE, inplace=True)
        self.all_modules = nn.Sequential(self.conv, self.norm, self.nonlin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv3d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride,
                     c.padding)
        # the norm and its LeakyReLU on the NDHWC view (no copy where y is
        # channels-last-3d, as cuDNN writes it on the card)
        y = instance_norm3d(y.permute(0, 2, 3, 4, 1).contiguous(),
                            self.norm.weight, self.norm.bias,
                            negative_slope=NEGATIVE_SLOPE, eps=EPS)
        return y.permute(0, 4, 1, 2, 3)


class StackedConvBlocks(nn.Module):
    def __init__(self, n: int, cin: int, cout: int, kernel, stride):
        super().__init__()
        self.convs = nn.Sequential(
            ConvDropoutNormReLU(cin, cout, kernel, stride),
            *[ConvDropoutNormReLU(cout, cout, kernel, (1, 1, 1))
              for _ in range(n - 1)])

    def forward(self, x):
        return self.convs(x)


class PlainConvEncoder(nn.Module):
    def __init__(self, plan: dict):
        super().__init__()
        cin, stages = plan["input_channels"], []
        for s, cout in enumerate(plan["features"]):
            stages.append(nn.Sequential(StackedConvBlocks(
                plan["n_conv_per_stage"][s], cin, cout,
                plan["kernel_sizes"][s], plan["strides"][s])))
            cin = cout
        self.stages = nn.Sequential(*stages)

    def forward(self, x) -> list:
        skips = []
        for stage in self.stages:
            x = stage(x)
            skips.append(x)
        return skips


class UNetDecoder(nn.Module):
    def __init__(self, encoder: PlainConvEncoder, plan: dict):
        super().__init__()
        self.encoder = encoder
        feats, strides = plan["features"], plan["strides"]
        stages, transp, seg = [], [], []
        for s in range(1, len(feats)):
            below, skip = feats[-s], feats[-(s + 1)]
            stride = tuple(strides[-s])
            transp.append(nn.ConvTranspose3d(below, skip, stride, stride,
                                             bias=True))
            stages.append(StackedConvBlocks(
                plan["n_conv_per_stage_decoder"][s - 1], 2 * skip, skip,
                plan["kernel_sizes"][-(s + 1)], (1, 1, 1)))
            seg.append(nn.Conv3d(skip, plan["classes"], 1, 1, 0, bias=True))
        self.stages = nn.ModuleList(stages)
        self.transpconvs = nn.ModuleList(transp)
        self.seg_layers = nn.ModuleList(seg)

    def forward(self, skips: list) -> torch.Tensor:
        x = skips[-1]
        for s, stage in enumerate(self.stages):
            t = self.transpconvs[s]
            up = F.conv_transpose3d(x, t.weight.to(x.dtype),
                                    t.bias.to(x.dtype), t.stride)
            x = stage(torch.cat((up, skips[-(s + 2)]), 1))
        head = self.seg_layers[-1]
        return F.conv3d(x, head.weight.to(x.dtype), head.bias.to(x.dtype))


class PlainConvUNet(nn.Module):
    """The network of a plan (``plan_from_nnunet``'s keys): NCDHW in, the
    last decoder stage's class logits out, in the input's dtype and memory
    format."""

    def __init__(self, plan: dict):
        super().__init__()
        self.plan = plan
        self.encoder = PlainConvEncoder(plan)
        self.decoder = UNetDecoder(self.encoder, plan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))

    @classmethod
    def from_canonical(cls, plan: dict, sd: dict) -> "PlainConvUNet":
        """The network with every key of its state dict taken from ``sd``
        (one key a parameter, ``canonical_key``'s), strictly."""
        net = cls(plan)
        net.load_state_dict({k: sd[canonical_key(k)]
                             for k in net.state_dict()}, strict=True)
        return net


def canonical_key(key: str) -> str:
    """The one key of a parameter that ``state_dict`` names twice:
    ``decoder.encoder.*`` is ``encoder.*``, ``all_modules.0`` / ``.1`` are
    ``conv`` / ``norm``."""
    if key.startswith("decoder.encoder."):
        key = key[len("decoder."):]
    return key.replace(".all_modules.0.", ".conv.").replace(
        ".all_modules.1.", ".norm.")


def for_inference(net: PlainConvUNet, device, dtype) -> PlainConvUNet:
    """``net`` on ``device`` for inference in ``dtype``: the convs'
    weights and biases cast once (the norms' affine stays fp32 for K2), no
    gradients."""
    net = net.to(device).eval().requires_grad_(False)
    for m in net.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            m.to(dtype)
            if device is not None and torch.device(device).type == "cuda":
                m.weight.data = m.weight.data.contiguous(
                    memory_format=torch.channels_last_3d)
    return net


def plan_from_nnunet(plans: dict, dataset: dict,
                     configuration: str = "3d_fullres") -> dict:
    """The port's plan from nnU-Net v2's ``plans.json`` and
    ``dataset.json``: the network's widths (``architecture.arch_kwargs``,
    or the older plans' keys), the patch size, the spacing (z, y, x), the
    classes (background included) and ``CTNormalization``'s numbers."""
    conf = plans["configurations"][configuration]
    arch = conf.get("architecture", {}).get("arch_kwargs")
    if arch is not None:
        features, kernels = arch["features_per_stage"], arch["kernel_sizes"]
        strides, n_enc = arch["strides"], arch["n_conv_per_stage"]
        n_dec = arch["n_conv_per_stage_decoder"]
    else:    # plans before nnU-Net 2.3, as TotalSegmentator v2's were written
        kernels = conf["conv_kernel_sizes"]
        strides = conf["pool_op_kernel_sizes"]
        features = [min(conf["UNet_base_num_features"] * 2 ** i,
                        conf["unet_max_num_features"])
                    for i in range(len(kernels))]
        n_enc = conf["n_conv_per_stage_encoder"]
        n_dec = conf["n_conv_per_stage_decoder"]
    props = plans["foreground_intensity_properties_per_channel"]["0"]
    return {"input_channels": len(dataset["channel_names"]),
            "features": list(features),
            "kernel_sizes": [list(k) for k in kernels],
            "strides": [list(s) for s in strides],
            "n_conv_per_stage": list(n_enc),
            "n_conv_per_stage_decoder": list(n_dec),
            "classes": len(dataset["labels"]),
            "patch_size": list(conf["patch_size"]),
            "spacing": [float(v) for v in conf["spacing"]],
            "normalization": {"lower": float(props["percentile_00_5"]),
                              "upper": float(props["percentile_99_5"]),
                              "mean": float(props["mean"]),
                              "std": float(props["std"])},
            "step": 0.5}


def load_nnunet(directory: str) -> tuple[PlainConvUNet, dict]:
    """(network, plan) of a trained nnU-Net model directory (the
    ``<trainer>__<plans>__3d_fullres`` folder TotalSegmentator keeps): the
    plan from its ``plans.json`` and ``dataset.json``, the weights from
    the first ``fold_*/checkpoint_final.pth`` loaded strictly. The
    checkpoint is a pickle of the trainer's state, read as nnU-Net reads
    it: load only a directory you trust."""
    with open(os.path.join(directory, "plans.json")) as f:
        plans = json.load(f)
    with open(os.path.join(directory, "dataset.json")) as f:
        dataset = json.load(f)
    plan = plan_from_nnunet(plans, dataset)
    ckpts = sorted(glob.glob(os.path.join(directory, "fold_*",
                                          "checkpoint_final.pth")))
    if not ckpts:
        raise FileNotFoundError(f"no fold_*/checkpoint_final.pth under "
                                f"{directory}")
    ckpt = torch.load(ckpts[0], map_location="cpu", weights_only=False)
    net = PlainConvUNet(plan)
    net.load_state_dict(ckpt["network_weights"], strict=True)
    return net, plan
