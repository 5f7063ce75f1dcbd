"""Flax-path -> torch state_dict key rules, and the variables bridge.

A copy of the key rules in ``islam_tpu/utils/checkpoints.py`` for VONet's
three subnets (flow, stereo, pose); the uncertainty-head and PSMNet rules
come with those networks.  ``state_dict_from_jax`` turns a nested dict of
arrays as the JAX package's ``tvo.init_params`` returns it (collections
``params`` and ``batch_stats``) into this port's state_dict, whose keys are
exactly the reference's torch keys:

- conv kernels HWIO -> OIHW;
- transposed-conv kernels, which the JAX package stores pre-flipped in HWIO,
  -> torch's (in, out, kh, kw), flipped back;
- Dense (in, out) -> Linear (out, in);
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

It needs no JAX: any object with ``__array__`` (numpy, jax arrays) works.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from collections.abc import Mapping
from typing import Optional, Tuple

import numpy as np
import torch


def _leaf_to_torch(leaf: str) -> str:
    return {
        "kernel": "weight", "bias": "bias", "scale": "weight",
        "mean": "running_mean", "var": "running_var",
    }[leaf]


def _pwcnet_key(parts: Tuple[str, ...]) -> str:
    # ('conv1a', 'conv') -> conv1a.0 ; ('predict_flow6',) -> predict_flow6
    if len(parts) == 2 and parts[1] == "conv":
        return parts[0] + ".0"
    return ".".join(parts)


def _voflownet_key(parts: Tuple[str, ...]) -> str:
    if parts[0] == "feat_net":
        sub = parts[1]
        m = re.fullmatch(r"head(\d)", sub)
        if m:
            return f"feat_net.{m.group(1)}.0"
        m = re.fullmatch(r"layer(\d+)_block(\d+)", sub)
        if m:
            li, bi = int(m.group(1)), int(m.group(2))
            rest = parts[2:]
            base = f"feat_net.{3 + li}.{bi}"
            if rest[0] == "conv1":
                return base + ".conv1.0"
            if rest[0] == "conv2":
                return base + ".conv2"
            if rest[0] == "downsample":
                return base + ".downsample"
    m = re.fullmatch(r"(trans|rot)_fc(\d)", parts[0])
    if m:
        head = "voflow_trans" if m.group(1) == "trans" else "voflow_rot"
        i = int(m.group(2)) - 1
        return f"{head}.{i}.0" if i < 2 else f"{head}.{i}"
    return ".".join(parts)


def _stereonet_key(parts: Tuple[str, ...]) -> str:
    if parts[0] == "feature_extraction":
        sub = parts[1]
        m = re.fullmatch(r"firstconv_(\d)", sub)
        if m:
            base = f"feature_extraction.firstconv.{2 * int(m.group(1))}"
            return base + (".0" if parts[2] == "conv" else ".1")
        m = re.fullmatch(r"layer(\d)_block(\d+)", sub)
        if m:
            base = f"feature_extraction.layer{m.group(1)}.{m.group(2)}"
            rest = parts[2:]
            if rest[0] == "conv1":
                return base + (".conv1.0.0" if rest[1] == "conv"
                               else ".conv1.0.1")
            if rest[0] == "conv2":
                return base + (".conv2.0" if rest[1] == "conv" else ".conv2.1")
            if rest[0] == "downsample_conv":
                return base + ".downsample.0"
            if rest[0] == "downsample_bn":
                return base + ".downsample.1"
        m = re.fullmatch(r"branch(\d)_conv", sub)
        if m:
            base = f"feature_extraction.branch{m.group(1)}.1"
            return base + (".0" if parts[2] == "conv" else ".1")
        if sub == "lastconv_0":
            return "feature_extraction.lastconv.0" + (
                ".0" if parts[2] == "conv" else ".1")
        if sub == "lastconv_1":
            return "feature_extraction.lastconv.2"
    # SSP branches: conv_c2_SSP/branchN_conv -> conv_c2_SSP.branchN.1
    out = []
    for p in parts:
        m = re.fullmatch(r"branch(\d)_conv", p)
        out.append(f"branch{m.group(1)}.1" if m else p)
    return ".".join(out)


_SUBNET_RULES = {
    "flowNet": _pwcnet_key,
    "stereoNet": _stereonet_key,
    "flowPoseNet": _voflownet_key,
}


def flax_path_to_torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """('params'|'batch_stats', subnet, ..., leaf) -> torch key, or None
    outside VONet's three subnets."""
    collection, *mods, leaf = path
    rule = _SUBNET_RULES.get(mods[0]) if mods else None
    if rule is None:
        return None
    return f"{mods[0]}.{rule(tuple(mods[1:]))}.{_leaf_to_torch(leaf)}"


def _is_transposed_conv(path: Tuple[str, ...]) -> bool:
    return any(p.startswith("deconv") or p.startswith("upfeat") for p in path)


def flax_value_to_torch(path: Tuple[str, ...], value) -> np.ndarray:
    """Move one flax leaf into the torch layout for its path."""
    v = np.asarray(value)
    if path[-1] == "kernel":
        if v.ndim == 4:
            if _is_transposed_conv(path):
                # pre-flipped HWIO -> ConvTranspose2d (in, out, kh, kw)
                v = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                v = v.transpose(3, 2, 0, 1)  # HWIO -> (out, in, kh, kw)
        elif v.ndim == 2:
            v = v.T  # Dense (in, out) -> Linear (out, in)
    return np.ascontiguousarray(v)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """Nested {collection: {module: ... {leaf: array}}} -> torch state_dict."""
    sd = OrderedDict()
    for path, value in _flatten(variables):
        key = flax_path_to_torch_key(path)
        if key is None:
            raise KeyError(f"no torch key for {'/'.join(path)}")
        sd[key] = grads_from_jax(path, value)
    return sd


def grads_from_jax(path: Tuple[str, ...], value) -> torch.Tensor:
    """One JAX leaf (a parameter or its gradient) at flax ``path`` as a
    tensor laid out like the port's parameter of that path."""
    return torch.from_numpy(flax_value_to_torch(path, value).copy())


def denoiser_state_dict_from_jax(dn_params) -> "OrderedDict[str, torch.Tensor]":
    """The JAX denoiser pytree (``islam_tpu.imu.denoiser.init_params``)
    -> ``IMUDenoiser`` state_dict.  Its layouts are already torch's; only
    ``decoder`` is renamed ``pose_decoder`` (train.py:705-719)."""
    sd = OrderedDict()
    for path, value in _flatten(dn_params):
        if path[0] == "decoder":
            path = ("pose_decoder",) + path[1:]
        sd[".".join(path)] = torch.from_numpy(np.array(value, np.float32))
    return sd
