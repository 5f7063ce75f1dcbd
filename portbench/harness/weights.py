"""Network weights drawn from the seed on the card, in a few large calls.

The VO networks are TartanVO's at their published widths; their weights
are random: a weight of fan-in f is normal with variance gain / f, clipped
at two standard deviations, biases are 0, BatchNorm scales 1 and shifts 0,
and the running statistics (kept in the state dict; the preset's train-mode
BatchNorm does not read them) are drawn too.  The gain is Kaiming's 2 and
1 in the linear layers, except where the configuration's ``weights`` set
it:

- ``stereo_decoder_gain`` and ``disp_bias``: Kaiming weights in the stereo
  net's decoder, which has no normalisation, give disparities of about
  -1e8 px, so that the scale recovery's mask is empty and every VO
  translation is 0; a smaller gain there and a bias on the disparity head
  put the disparity where a trained network puts it on the drive, while
  every layer still shapes it;
- ``rot_head_gain`` (1 where not given), of the rotation head's last
  layer: random pose heads turn 0.9-1.4 rad a frame, and the metric scale
  fitted to that rotation gives translations far from the drive's.  A
  cell that trains the head brings it near the IMU's within its first
  steps; a serving cell needs the head's rotations small from the start.

The denoiser follows the reference's initialiser (uniform in
+-1/sqrt(fan), the decoder's biases 0).
"""

from __future__ import annotations

import math

import torch

from portbench.ref import nets

TRANSPOSED = ("deconv", "upfeat")
KAIMING = 2.0
ROT_HEAD = "flowPoseNet.voflow_rot.2.weight"


def _gain(key: str, shape, w: dict) -> float:
    if key == ROT_HEAD:
        return w.get("rot_head_gain", 1.0)
    if len(shape) == 2:
        return 1.0
    if key.startswith("stereoNet.") and not key.startswith(
            "stereoNet.feature_extraction."):
        return w["stereo_decoder_gain"]
    return KAIMING


def vonet(height: int, width: int, spec: dict, seed: int, device):
    """{key: tensor} of a VONet for (height, width) inputs, on ``device``."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  nets.VONet(height, width).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [k for k, s in shapes.items()
             if k.endswith(".weight") and len(s) >= 2]
    total = sum(math.prod(shapes[k]) for k in drawn)
    noise = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    stats = [k for k in shapes if k.endswith(("running_mean", "running_var"))]
    n_stats = sum(math.prod(shapes[k]) for k in stats)
    u = torch.rand(n_stats, generator=gen, device=device)
    out, off, soff = {}, 0, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        if k in drawn:
            if len(shape) == 2:
                fan = shape[1]
            elif k.rsplit(".", 2)[-2].startswith(TRANSPOSED):
                fan = shape[0] * math.prod(shape[2:])
            else:
                fan = math.prod(shape[1:])
            gain = _gain(k, shape, spec)
            out[k] = noise[off:off + n].view(shape) * math.sqrt(gain / fan)
            off += n
        elif k in stats:
            x = u[soff:soff + n].view(shape)
            out[k] = (0.2 * x - 0.1 if k.endswith("mean") else 0.5 + x)
            soff += n
        elif k.endswith(".weight"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    out["stereoNet.conv_c13.bias"].fill_(spec["disp_bias"])
    return out


DENOISER_FAN = {"conv1": 60, "gru": 128, "pose_decoder.0": 128,
                "pose_decoder.2": 64}
DENOISER_SHAPES = {
    "conv1.weight": (64, 6, 10), "conv1.bias": (64,),
    "gru.weight_ih_l0": (384, 64), "gru.weight_hh_l0": (384, 128),
    "gru.bias_ih_l0": (384,), "gru.bias_hh_l0": (384,),
    "pose_decoder.0.weight": (64, 128), "pose_decoder.0.bias": (64,),
    "pose_decoder.2.weight": (6, 64), "pose_decoder.2.bias": (6,)}


def denoiser(seed: int, device):
    """{key: tensor} of the IMU denoiser (the reference's state-dict keys),
    drawn on ``device`` from a generator of its own."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    total = sum(math.prod(s) for s in DENOISER_SHAPES.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for k, shape in DENOISER_SHAPES.items():
        n = math.prod(shape)
        part = k.rsplit(".", 1)[0]
        if part.startswith("pose_decoder") and k.endswith("bias"):
            out[k] = torch.zeros(shape, device=device)
        else:
            out[k] = u[off:off + n].view(shape) / math.sqrt(DENOISER_FAN[
                part.split(".")[0] if part.startswith(("conv1", "gru"))
                else part])
        off += n
    return out
