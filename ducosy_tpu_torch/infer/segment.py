"""Sliding-window 3-D segmentation on the card: nnU-Net v2's inference
(``nnunetv2/inference/predict_from_raw_data.py``, ``sliding_window_
prediction.py``) for the ``PlainConvUNet`` of ``models/nnunet.py``, as
TotalSegmentator runs it on a CT series.

For each patient ``Segmenter.segment_async``:
  1. uploads the HU volume (z, y, x) and resamples it to the plan's
     spacing, trilinear on the card (align-corners: the first and last
     voxels keep their places, as ``scipy.ndimage.zoom`` maps them), to
     nnU-Net's shape round(size * spacing / target). TotalSegmentator's
     ``change_spacing`` resamples with cubic splines; trilinear is this
     port's departure, and the benchmark's configuration lists it;
  2. applies ``CTNormalization``: clip to the foreground's 0.5 and 99.5
     percentiles, subtract the mean, divide by the std;
  3. pads each axis shorter than the patch to it with zeros, centred
     (``pad_nd_image``);
  4. takes the patch origins of ``compute_steps_for_sliding_window`` at
     step 0.5 of the patch, runs the patches through the network in batches
     of ``patch_batch``, weights each patch's logits by the Gaussian
     importance map (sigma = patch / 8, peak 10, zeros raised to the
     smallest non-zero value) and accumulates the weighted logits and the
     weights in fp32 on the card (no mirroring: TotalSegmentator's trainer
     ``nnUNetTrainerNoMirroring``);
  5. divides, drops the padding, takes the argmax (uint8 labels), and
     resamples the labels back to the series grid by nearest neighbour
     (``ndimage.zoom(order=0)``'s align-corners index, round half up).

Nothing waits for the card in ``segment_async``: the input is staged in
pinned memory and uploaded without blocking, and the labels come back as a
device tensor with an event recorded after them. ``download`` copies them
into pinned memory on a copy stream of its own once that event has
passed, so a caller that launches patient i before it downloads patient
i - 1 (as the generate CLI does) has i - 1's copy overlap i's compute, and
the host stays a patient ahead of the card. ``segment_volume`` is one
patient launched and downloaded.

Traced (``trace.py``): the span ``seg.patient`` (request: the segmenter's
count of patients) holds ``seg.upload``, ``seg.resample`` (twice: to the
plan's grid, and the labels back), ``seg.normalize``, one ``seg.window`` (the
patches gathered and the network's forward) and one ``seg.accumulate`` a
batch of patches, and ``seg.argmax``; ``download`` is ``seg.download``
(a root of its own); the counters ``seg.patches``,
``seg.patch_voxels`` (patches x patch voxels run through the network) and
``seg.volume_voxels`` (voxels of the resampled volume) count every call.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ducosy_tpu_torch import trace
from ducosy_tpu_torch.device import require_cuda
from ducosy_tpu_torch.models.nnunet import PlainConvUNet, for_inference

SIGMA_SCALE = 1.0 / 8
VALUE_SCALING = 10.0


def resampled_shape(shape, spacing, target) -> tuple:
    """nnU-Net's ``compute_new_shape``: round(size * spacing / target)
    on each axis."""
    return tuple(int(round(n * s / t)) for n, s, t in zip(shape, spacing,
                                                         target))


def sliding_window_steps(image_size, tile_size, step: float) -> list:
    """Patch origins on each axis (nnU-Net's
    ``compute_steps_for_sliding_window``): ceil((size - tile) / (tile *
    step)) + 1 origins, spread evenly from 0 to size - tile and rounded."""
    steps = []
    for size, tile in zip(image_size, tile_size):
        if size < tile:
            raise ValueError(f"image size {size} below the tile {tile}")
        n = int(np.ceil((size - tile) / (tile * step))) + 1
        actual = (size - tile) / (n - 1) if n > 1 else 99999999999
        steps.append([int(np.round(actual * i)) for i in range(n)])
    return steps


def gaussian_map(patch, device, sigma_scale: float = SIGMA_SCALE,
                 value_scaling: float = VALUE_SCALING) -> torch.Tensor:
    """nnU-Net's importance map over a patch in fp32: a Gaussian centred at
    patch // 2 with sigma patch * sigma_scale on each axis, scaled to a
    peak of ``value_scaling``, its zeros raised to its smallest non-zero
    value. (nnU-Net filters a delta with ``gaussian_filter``, whose kernel
    reaches 4 sigma = patch / 2: the same products of exponentials.)"""
    g = torch.ones((), dtype=torch.float64, device=device)
    for i, p in enumerate(patch):
        x = torch.arange(p, dtype=torch.float64, device=device) - p // 2
        g1 = torch.exp(-0.5 * (x / (p * sigma_scale)) ** 2)
        g = g[..., None] * g1.view(*([1] * i), p)
    g = (g / g.max() * value_scaling).to(torch.float32)
    zero = g == 0
    return torch.where(zero, g[~zero].min(), g) if zero.any() else g


def align_corners_index(n_out: int, n_in: int, device) -> torch.Tensor:
    """Source index of each output index for nearest resampling with the
    first and last voxels aligned: floor(o * (n_in - 1) / (n_out - 1) +
    0.5), in float64."""
    if n_out == 1:
        return torch.zeros(1, dtype=torch.long, device=device)
    o = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor(o * (n_in - 1) / (n_out - 1) + 0.5).long()


def resample_labels(labels: torch.Tensor, shape) -> torch.Tensor:
    """Nearest-neighbour resampling of a (z, y, x) label volume to
    ``shape``, one gather an axis."""
    for axis, n in enumerate(shape):
        idx = align_corners_index(n, labels.shape[axis], labels.device)
        labels = labels.index_select(axis, idx)
    return labels


class Segmentation(NamedTuple):
    """A launched patient: ``labels`` (z, y, x) uint8 on the card at the
    series grid; ``logits`` (classes, z, y, x) fp32 at the plan's grid,
    the accumulated and divided sliding-window logits, where asked for;
    ``done`` the event recorded after the labels (None on the CPU)."""
    labels: torch.Tensor
    logits: torch.Tensor | None
    done: object = None


class Segmenter:
    """A network and its plan on one device, ready for patients.

    ``net``: a ``PlainConvUNet`` (its plan is ``net.plan``); ``plan`` adds
    the inference keys (``patch_size``, ``spacing`` (z, y, x),
    ``normalization`` {lower, upper, mean, std}, ``step``).
    ``patch_batch`` patches go through the network at once.
    """

    def __init__(self, net: PlainConvUNet, plan: dict, *, device="cuda",
                 dtype=torch.bfloat16, patch_batch: int = 4):
        self.device = require_cuda(device)
        self.dtype = dtype
        self.plan = plan
        self.patch = tuple(plan["patch_size"])
        self.patch_batch = patch_batch
        self.net = for_inference(net, self.device, dtype)
        self.gaussian = gaussian_map(self.patch, self.device)
        self.card = self.device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.device) if self.card \
            else None
        self.patients = 0

    def _upload(self, hu: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(hu))
        if self.card:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _prepare(self, hu, spacing) -> torch.Tensor:
        """The normalized volume at the plan's grid, fp32 (z, y, x)."""
        with trace.span("seg.upload"):
            vol = self._upload(hu)
        shape = resampled_shape(hu.shape, spacing, self.plan["spacing"])
        with trace.span("seg.resample"):
            vol = vol.to(torch.float32)
            if tuple(vol.shape) != shape:
                vol = F.interpolate(vol[None, None], size=shape,
                                    mode="trilinear", align_corners=True)[0, 0]
        with trace.span("seg.normalize"):
            nz = self.plan["normalization"]
            vol = vol.clamp_(nz["lower"], nz["upper"]).sub_(nz["mean"]).div_(
                max(nz["std"], 1e-8))
        return vol

    def _forward(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, classes, *patch) logits of (B, 1, *patch) inputs."""
        x = patches.to(self.dtype)
        if self.card:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        return self.net(x)

    def segment_async(self, hu: np.ndarray, spacing, *,
                      logits: bool = False) -> Segmentation:
        """Launch one patient: ``hu`` (z, y, x) HU on the host (any real
        dtype), ``spacing`` (z, y, x) in mm."""
        self.patients += 1
        with trace.span("seg.patient", self.patients):
            return self._patient(hu, tuple(float(s) for s in spacing),
                                 logits)

    def _patient(self, hu, spacing, keep_logits: bool) -> Segmentation:
        vol = self._prepare(hu, spacing)
        shape = tuple(vol.shape)
        trace.count("seg.volume_voxels", math.prod(shape))
        # pad each axis up to the patch, centred (pad_nd_image)
        pads = [max(p - n, 0) for n, p in zip(shape, self.patch)]
        if any(pads):
            flat = [v for d in reversed(pads) for v in (d // 2, d - d // 2)]
            vol = F.pad(vol, flat)
        padded = tuple(vol.shape)
        k = self.plan["classes"]
        acc = torch.zeros((*padded, k), dtype=torch.float32,
                          device=self.device)
        weight = torch.zeros(padded, dtype=torch.float32, device=self.device)
        origins = list(itertools.product(*sliding_window_steps(
            padded, self.patch, self.plan["step"])))
        trace.count("seg.patches", len(origins))
        trace.count("seg.patch_voxels", len(origins) * math.prod(self.patch))
        gauss = self.gaussian
        for b0 in range(0, len(origins), self.patch_batch):
            batch = origins[b0:b0 + self.patch_batch]
            boxes = [tuple(slice(o, o + p) for o, p in zip(org, self.patch))
                     for org in batch]
            with trace.span("seg.window"):
                out = self._forward(torch.stack([vol[bx] for bx in boxes])
                                    [:, None])
            with trace.span("seg.accumulate"):
                # (B, k, z, y, x) channels-last -> (B, z, y, x, k) views
                out = out.permute(0, 2, 3, 4, 1)
                for i, bx in enumerate(boxes):
                    acc[bx].addcmul_(out[i], gauss[..., None])
                    weight[bx].add_(gauss)
        with trace.span("seg.argmax"):
            inner = tuple(slice(d // 2, d // 2 + n) for d, n in zip(pads,
                                                                     shape))
            acc = acc[inner].div_(weight[inner][..., None])
            labels = acc.argmax(dim=-1).to(torch.uint8)
        with trace.span("seg.resample"):
            labels = resample_labels(labels, hu.shape)
        done = None
        if self.card:
            done = torch.cuda.Event()
            done.record()
        return Segmentation(labels, acc.permute(3, 0, 1, 2) if keep_logits
                            else None, done)

    def download(self, seg: Segmentation) -> np.ndarray:
        """A launched patient's labels on the host: on the card, copied
        into pinned memory on the copy stream once ``seg.done`` has
        passed, waiting for that copy alone."""
        if not self.card:
            return seg.labels.numpy()
        with trace.span("seg.download"):
            host = torch.empty(seg.labels.shape, dtype=torch.uint8,
                               pin_memory=True)
            stream = self.copy_stream
            stream.wait_event(seg.done)
            with torch.cuda.stream(stream):
                host.copy_(seg.labels, non_blocking=True)
            seg.labels.record_stream(stream)
            copied = torch.cuda.Event()
            copied.record(stream)
            copied.synchronize()
        return host.numpy()


def segment_volume(hu: np.ndarray, spacing, net: PlainConvUNet, plan: dict,
                   **kw) -> np.ndarray:
    """The uint8 label volume (z, y, x) of ``hu`` at the series grid."""
    segmenter = Segmenter(net, plan, **kw)
    return segmenter.download(segmenter.segment_async(hu, spacing))
