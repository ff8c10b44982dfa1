"""Checkpoints of the four networks: the reference ``.pth`` key layouts, the
JAX params trees, and seeded numpy inits (ducosy_tpu/models/
torch_import.py:31-177).

The reference Generator is an ``nn.Sequential`` (modules/model.py:94-113);
for R residual blocks its state dict holds
  model.1 stem 7x7, model.4 / model.7 stride-2 down convs,
  model.{10+i}.block.{1,5} residual convs, with CBAM weights under
  model.{10+i}.cbam.channel_attention.fc.{0,2} and
  model.{10+i}.cbam.spatial_attention.conv,
  model.{11+R} up1, model.{15+R} up2, model.{19+R} head.
The reference Discriminator is an ``nn.Sequential`` too (modules/model.py:
118-131): convs at model.{0,2,5,8} and the head at model.12. The port's
``Generator`` and ``Discriminator`` use these layouts as their own
``state_dict``, so reference files load with ``load_state_dict``.
Conversion from the JAX trees only transposes: flax conv (kh, kw, I, O) ->
torch (O, I, kh, kw), dense (I, O) -> 1x1 conv (O, I, 1, 1).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

INIT_STD = 0.02  # weights_init_normal (modules/model.py:134-140)


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel's ``module.`` prefix (generate.py:38-43)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Read a ``.pth`` generator state dict on the CPU. A full training
    checkpoint (``G_A2B_state_dict`` among its keys) is returned as is."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not contain a state dict")
    if "G_A2B_state_dict" in sd:
        return dict(sd)
    return strip_module_prefix(sd)


def _conv_to_torch(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _dense_to_torch(k) -> np.ndarray:
    a = np.asarray(k).T
    return np.ascontiguousarray(a.reshape(a.shape[0], a.shape[1], 1, 1))


def num_residual_blocks(params: Dict[str, Any]) -> int:
    """Trunk depth of a JAX params tree (``block{i}`` keys)."""
    blocks = [int(k[5:]) for k in params if k.startswith("block")]
    return max(blocks) + 1 if blocks else 0


def generator_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX Generator params (numpy or array leaves) -> the port's state dict
    (numpy values, reference key layout)."""
    r = num_residual_blocks(params)
    sd: Dict[str, np.ndarray] = {}

    def put(key, p):
        sd[f"{key}.weight"] = _conv_to_torch(p["kernel"])
        sd[f"{key}.bias"] = np.asarray(p["bias"])

    for name, idx in (("stem", 1), ("down1", 4), ("down2", 7)):
        put(f"model.{idx}", params[name])
    for i in range(r):
        blk, base = params[f"block{i}"], f"model.{10 + i}"
        put(f"{base}.block.1", blk["conv1"])
        put(f"{base}.block.5", blk["conv2"])
        if "ca" in blk:
            cbam = f"{base}.cbam"
            sd[f"{cbam}.channel_attention.fc.0.weight"] = \
                _dense_to_torch(blk["ca"]["fc1"]["kernel"])
            sd[f"{cbam}.channel_attention.fc.2.weight"] = \
                _dense_to_torch(blk["ca"]["fc2"]["kernel"])
            sd[f"{cbam}.spatial_attention.conv.weight"] = \
                _conv_to_torch(blk["sa"]["conv"]["kernel"])
    for name, idx in (("up1", 11 + r), ("up2", 15 + r), ("head", 19 + r)):
        put(f"model.{idx}", params[name])
    return sd


def generator_shapes(in_ch: int = 1, base: int = 64,
                     blocks: int = 9) -> Dict[str, tuple]:
    """State-dict key -> shape for a CBAM generator, in module order."""
    c = 4 * base
    r = c // 16
    shapes: Dict[str, tuple] = {}

    def conv(key, o, i, k):
        shapes[f"{key}.weight"] = (o, i, k, k)
        shapes[f"{key}.bias"] = (o,)

    conv("model.1", base, in_ch, 7)
    conv("model.4", 2 * base, base, 3)
    conv("model.7", c, 2 * base, 3)
    for i in range(blocks):
        b = f"model.{10 + i}"
        conv(f"{b}.block.1", c, c, 3)
        conv(f"{b}.block.5", c, c, 3)
        shapes[f"{b}.cbam.channel_attention.fc.0.weight"] = (r, c, 1, 1)
        shapes[f"{b}.cbam.channel_attention.fc.2.weight"] = (c, r, 1, 1)
        shapes[f"{b}.cbam.spatial_attention.conv.weight"] = (1, 2, 7, 7)
    conv(f"model.{11 + blocks}", 2 * base, c, 3)
    conv(f"model.{15 + blocks}", base, 2 * base, 3)
    conv(f"model.{19 + blocks}", 1, base, 7)
    return shapes


def init_generator_state_dict(seed: int, in_ch: int = 1, base: int = 64,
                              blocks: int = 9) -> Dict[str, np.ndarray]:
    """Seeded random CBAM generator in numpy: every weight N(0, 0.02),
    every bias zero (ducosy_tpu/models/layers.py:45-48). Needs neither JAX
    nor a checkpoint file."""
    return _normal_init(seed, generator_shapes(in_ch, base, blocks))


DISC_IDX = {"conv1": 0, "conv2": 2, "conv3": 5, "conv4": 8, "head": 12}


def discriminator_state_dict_from_jax(params: Dict[str, Any]
                                      ) -> Dict[str, np.ndarray]:
    """JAX Discriminator params -> the port's state dict (numpy values,
    reference key layout, torch_import.py:158-177)."""
    sd: Dict[str, np.ndarray] = {}
    for name, idx in DISC_IDX.items():
        sd[f"model.{idx}.weight"] = _conv_to_torch(params[name]["kernel"])
        sd[f"model.{idx}.bias"] = np.asarray(params[name]["bias"])
    return sd


def cyclegan_state_dicts_from_jax(state) -> Dict[str, Dict[str, np.ndarray]]:
    """The four networks of a JAX ``CycleGANState`` (any object with its
    ``params_*`` attributes, numpy or array leaves) as the port's state
    dicts, keyed g_a2b, g_b2a, d_a, d_b."""
    return {"g_a2b": generator_state_dict_from_jax(state.params_g_a2b),
            "g_b2a": generator_state_dict_from_jax(state.params_g_b2a),
            "d_a": discriminator_state_dict_from_jax(state.params_d_a),
            "d_b": discriminator_state_dict_from_jax(state.params_d_b)}


def discriminator_shapes(in_ch: int = 1, base: int = 64) -> Dict[str, tuple]:
    """State-dict key -> shape for a PatchGAN discriminator."""
    chans = (in_ch, base, 2 * base, 4 * base, 8 * base)
    shapes: Dict[str, tuple] = {}
    for i, idx in enumerate(DISC_IDX.values()):
        cin, cout = (chans[i], chans[i + 1]) if i < 4 else (chans[4], 1)
        shapes[f"model.{idx}.weight"] = (cout, cin, 4, 4)
        shapes[f"model.{idx}.bias"] = (cout,)
    return shapes


def _normal_init(seed: int, shapes: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in shapes.items():
        if key.endswith(".bias"):
            sd[key] = np.zeros(shape, np.float32)
        else:
            sd[key] = rng.normal(0.0, INIT_STD, shape).astype(np.float32)
    return sd


def init_discriminator_state_dict(seed: int, in_ch: int = 1,
                                  base: int = 64) -> Dict[str, np.ndarray]:
    """Seeded random discriminator in numpy: weights N(0, 0.02), biases
    zero, as ``init_generator_state_dict``."""
    return _normal_init(seed, discriminator_shapes(in_ch, base))
