"""Checkpoints: the reference's ``.pkl`` weights in, the port's own saves
out and back.

Counterpart of ``islam_tpu/utils/checkpoints.py`` and ``_import_denoiser``
(``islam_tpu/train.py``):

- ``load_torch_state_dict``: a reference ``.pkl`` as CPU tensors;
- ``import_denoiser``: the IMU denoiser's entries (``--imu-denoise-model-name``);
- ``import_torch_weights``: the lenient VO loader (TartanVO.py:49-87,
  ``islam_tpu/utils/checkpoints.py:204-274``) for ``--vo-model-name`` and
  ``--pose-model-name``.  The port's parameter names are the reference's
  torch keys, so it only matches: the exact key first, then the
  ``predict_flowN.pred.*`` alias of the uncertainty checkpoints (and, for
  a net with uncertainty heads, the plain ``predict_flowN.*`` of the
  others, which the JAX loader also reads into it), then a mutual suffix
  with an equal element count.  Unmatched entries keep their
  values; nothing matched raises;
- ``save_checkpoint`` / ``restore_checkpoint`` / ``latest_checkpoint_step``:
  the per-epoch saves under ``{dir}/{epoch}/`` and the resume scan
  (train.py:102-107,181-189), in torch's format.  The JAX package's
  orbax saves come in as numpy arrays, through ``utils/jax_state.py``.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, Optional

import torch

DENOISER_KEYS = (
    "conv1.weight", "conv1.bias",
    "gru.weight_ih_l0", "gru.weight_hh_l0", "gru.bias_ih_l0",
    "gru.bias_hh_l0",
    "pose_decoder.0.weight", "pose_decoder.0.bias",
    "pose_decoder.2.weight", "pose_decoder.2.bias",
)
CHECKPOINT_FILE = "checkpoint.pt"
# uncertainty checkpoints wrap the flow convs in PredictFlow: the weights of
# predict_flowN and dc_conv7 live at <name>.pred.<leaf>
_PRED_ALIAS = re.compile(r"((?:flowNet\.)?(?:predict_flow\d|dc_conv7))"
                         r"(\.pred)?\.(weight|bias)")


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


def _source(key: str, numel: int, state_dict: Dict[str, torch.Tensor]):
    candidates = [key]
    m = _PRED_ALIAS.fullmatch(key)
    if m:
        candidates.append(f"{m.group(1)}{'' if m.group(2) else '.pred'}."
                          f"{m.group(3)}")
    for cand in candidates:
        if cand in state_dict:
            return state_dict[cand]
    for k, v in state_dict.items():
        if (k.endswith(key) or key.endswith(k)) and v.numel() == numel:
            return v
    return None


@torch.no_grad()
def import_torch_weights(model: torch.nn.Module,
                         state_dict: Dict[str, torch.Tensor],
                         verbose: bool = False) -> list:
    """Copy into ``model`` every parameter and buffer that ``state_dict``
    supplies under the lenient matching; returns the keys loaded.  Raises
    if nothing matches (TartanVO.py:66-67)."""
    loaded, missing = [], []
    for key, target in model.state_dict(keep_vars=True).items():
        value = _source(key, target.numel(), state_dict)
        if value is not None and value.numel() == target.numel():
            target.copy_(value.reshape(target.shape))
            loaded.append(key)
        else:
            missing.append(key)
    if not loaded:
        raise RuntimeError("Could not match any torch weights.")
    if verbose:
        for key in missing:
            print(f"! [import_torch_weights] no source for {key}")
    return loaded


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Write ``state`` as ``{directory}/{step}/checkpoint.pt``, atomically;
    returns the file's path."""
    path = os.path.join(directory, str(step))
    os.makedirs(path, exist_ok=True)
    path = os.path.join(path, CHECKPOINT_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, step: int, device="cpu") -> dict:
    """The state saved by ``save_checkpoint``, with tensors on ``device``."""
    path = os.path.join(directory, str(step), CHECKPOINT_FILE)
    return torch.load(path, map_location=device)


def latest_checkpoint_step(directory: str, before: int) -> Optional[int]:
    """The newest saved epoch k < ``before`` (the reference's resume scan,
    train.py:102-107), or None."""
    for i in range(before - 1, 0, -1):
        if os.path.isfile(os.path.join(directory, str(i), CHECKPOINT_FILE)):
            return i
    return None
