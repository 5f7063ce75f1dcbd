"""Flax-path -> torch state_dict key rules, and the variables bridge.

A copy of the key rules in ``islam_tpu/utils/checkpoints.py``: VONet's
three subnets (flow, stereo, pose), the PWC uncertainty heads, the PSMNets,
and standalone networks by their first module's name.  The multi-camera
pose head's modules (``feat_net2``, ``extrinsic_fc*``, ``fcAB_trans``,
``fcAC_trans``, ``trans_head_*``) have no rule there, and the JAX package
names no reference key for them; here ``feat_net2`` is laid out as
``feat_net`` and each Linear-ReLU ``<name>/fc`` is ``<name>.0``, as the
single-camera heads' are.  ``state_dict_from_jax`` turns a nested dict of
arrays as the JAX package's ``init_params`` / ``Module.init`` return it
(collections ``params`` and ``batch_stats``) into this port's state_dict,
whose keys are exactly the reference's torch keys:

- conv kernels (D)HWIO -> torch's (out, in, ...);
- transposed-conv kernels, which the JAX package stores pre-flipped in
  (D)HWIO, -> torch's (in, out, ...), flipped back;
- Dense (in, out) -> Linear (out, in);
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
- with uncertainty heads, the flow convs ``predict_flowN`` and ``dc_conv7``
  -> ``<name>.pred.*``, as the reference's uncertainty checkpoints hold
  them.

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


_UNC_IDX = {"conv0": "0", "conv1": "2", "conv2": "4"}


def _pwcnet_key(parts: Tuple[str, ...]) -> str:
    # ('conv1a', 'conv') -> conv1a.0 ; ('predict_flow6',) -> predict_flow6
    # uncertainty heads (PWCNet.py:22-33,39-52):
    #   ('unc6', 'conv0') -> predict_flow6.unc.0 ; dc_unc7 -> dc_conv7.unc.*
    m = re.fullmatch(r"unc(\d)", parts[0])
    if m and len(parts) == 2:
        return f"predict_flow{m.group(1)}.unc.{_UNC_IDX[parts[1]]}"
    if parts[0] == "dc_unc7" and len(parts) == 2:
        return f"dc_conv7.unc.{_UNC_IDX[parts[1]]}"
    if len(parts) == 2 and parts[1] == "conv":
        return parts[0] + ".0"
    return ".".join(parts)


# the multi-camera head's Linear-ReLU layers: <name>/fc -> <name>.0
_MULTICAM_FC = re.compile(
    r"extrinsic_fc\d+|fcA[BC]_trans|trans_head_(?:fc[12]|mid\d+)")


def _voflownet_key(parts: Tuple[str, ...]) -> str:
    if parts[0] in ("feat_net", "feat_net2"):
        net, sub = parts[0], parts[1]
        m = re.fullmatch(r"head(\d)", sub)
        if m:
            return f"{net}.{m.group(1)}.0"
        m = re.fullmatch(r"layer(\d+)_block(\d+)", sub)
        if m:
            li, bi = int(m.group(1)), int(m.group(2))
            rest = parts[2:]
            base = f"{net}.{3 + li}.{bi}"
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
    if _MULTICAM_FC.fullmatch(parts[0]) and parts[1:] == ("fc",):
        return parts[0] + ".0"
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


def _psmnet_key(parts: Tuple[str, ...]) -> str:
    """PSMNet alternates (PSM/{basic,stackhourglass}.py) name translation.

    torch containers: dresN/classifN/classify are Sequential(convbn_3d, ReLU,
    <convbn_3d | Conv3d>) -> items 0 and 2; hourglass convK are
    Sequential(convbn_3d, ReLU) / bare convbn_3d / Sequential(ConvTranspose3d,
    BatchNorm3d); convbn_3d itself is Sequential(Conv3d, BatchNorm3d).
    """
    head = parts[0]
    m = re.fullmatch(r"(dres\d|classif\d|classify)_(\d)", head)
    if m:
        base = f"{m.group(1)}.{2 * int(m.group(2))}"
        if len(parts) == 1:  # bare Conv3d (classifN_1 / classify_1)
            return base
        return base + (".0" if parts[1] == "conv" else ".1")
    if re.fullmatch(r"dres\d", head) and len(parts) >= 2:
        sub = parts[1]
        m = re.fullmatch(r"conv(\d)_(conv|bn)", sub)
        if m:  # hourglass deconv: Sequential(ConvTranspose3d, BN3d)
            return f"{head}.conv{m.group(1)}." + (
                "0" if m.group(2) == "conv" else "1")
        if sub == "conv2":  # bare convbn_3d (stackhourglass.py:17)
            return f"{head}.conv2." + ("0" if parts[2] == "conv" else "1")
        return f"{head}.{sub}.0." + ("0" if parts[2] == "conv" else "1")
    return ".".join(parts)


_SUBNET_RULES = {
    "flowNet": _pwcnet_key,
    "stereoNet": _stereonet_key,
    "flowPoseNet": _voflownet_key,
}


def _guess_rule(head: str):
    """The rule for a standalone (un-wrapped) network, from its first
    module's name."""
    if head in ("feat_net", "feat_net2") or re.fullmatch(
            r"(trans|rot)_fc\d|trans_head_fc3", head) or (
            _MULTICAM_FC.fullmatch(head)):
        return _voflownet_key
    if re.fullmatch(r"(dres\d|classif\d|classify)(_\d)?", head):
        return _psmnet_key
    if (head == "feature_extraction" or head.startswith("conv_c")
            or head.startswith("deconv_c")):
        return _stereonet_key
    return _pwcnet_key


def flax_path_to_torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """('params'|'batch_stats', subnet or module, ..., leaf) -> torch key:
    VONet's subnets by name, a standalone network by its first module's
    name.  None for a leaf outside any module."""
    collection, *mods, leaf = path
    if not mods:
        return None
    rule = _SUBNET_RULES.get(mods[0])
    if rule is None:
        return f"{_guess_rule(mods[0])(tuple(mods))}.{_leaf_to_torch(leaf)}"
    return f"{mods[0]}.{rule(tuple(mods[1:]))}.{_leaf_to_torch(leaf)}"


def _is_transposed_conv(path: Tuple[str, ...]) -> bool:
    return any(p.startswith("deconv") or p.startswith("upfeat")
               or re.fullmatch(r"conv[56]_conv", p)  # 3-D hourglass deconvs
               for p in path)


def flax_value_to_torch(path: Tuple[str, ...], value) -> np.ndarray:
    """Move one flax leaf into the torch layout for its path."""
    v = np.asarray(value)
    if path[-1] == "kernel":
        if v.ndim in (4, 5):
            if _is_transposed_conv(path):
                # pre-flipped (D)HWIO -> ConvTranspose (in, out, k...)
                v = np.flip(np.moveaxis(v, (-2, -1), (0, 1)),
                            tuple(range(2, v.ndim)))
            else:
                # (D)HWIO -> (out, in, k...)
                v = np.moveaxis(v, (-1, -2), (0, 1))
        elif v.ndim == 2:
            v = v.T  # Dense (in, out) -> Linear (out, in)
    return np.ascontiguousarray(v)


# uncertainty checkpoints wrap the flow convs: <name>.pred.<leaf>
_PRED_WRAP = re.compile(r"((?:flowNet\.)?(?:predict_flow\d|dc_conv7))"
                        r"\.(weight|bias)")


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
    if any(".unc." in k for k in sd):
        sd = OrderedDict((_PRED_WRAP.sub(r"\1.pred.\2", k)
                          if _PRED_WRAP.fullmatch(k) else k, v)
                         for k, v in sd.items())
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
