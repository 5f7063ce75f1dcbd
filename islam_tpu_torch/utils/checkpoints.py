"""Reading the reference's denoiser checkpoint.

Counterpart of ``load_torch_state_dict`` (``islam_tpu/utils/checkpoints.py``)
and ``_import_denoiser`` (``islam_tpu/train.py``) for the one checkpoint the
training path reads: the IMU denoiser ``.pkl`` behind
``--imu-denoise-model-name``.  Orbax checkpoints, model saving, resume and
the lenient suffix-matching VO loader are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

DENOISER_KEYS = (
    "conv1.weight", "conv1.bias",
    "gru.weight_ih_l0", "gru.weight_hh_l0", "gru.bias_ih_l0",
    "gru.bias_hh_l0",
    "pose_decoder.0.weight", "pose_decoder.0.bias",
    "pose_decoder.2.weight", "pose_decoder.2.bias",
)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pkl`` checkpoint as a dict of CPU tensors; a nested
    ``state_dict`` entry is unwrapped."""
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: v.detach() for k, v in sd.items() if torch.is_tensor(v)}


def import_denoiser(sd: Dict[str, torch.Tensor]) -> "OrderedDict":
    """The denoiser's entries of a reference state dict (train.py:705-719);
    a missing key raises ``KeyError``."""
    return OrderedDict((k, sd[k]) for k in DENOISER_KEYS)
