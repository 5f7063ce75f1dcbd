"""A JAX run's saves, carried into the port's checkpoints.

The JAX package saves an epoch with orbax (``islam_tpu/utils/
checkpoints.py::save_checkpoint``): the pytree of ``Trainer._ckpt_state``
(``vo_variables``, ``vo_opt_state`` and, with a denoiser, ``dn_params``,
``imu_opt_state``) or of ``MultiSequenceTrainer._ckpt_state`` (``opt_state``
for the pose head's, and ``seq_states``).  The state crosses as numpy
arrays, as the weights do (``weights.state_dict_from_jax``): on a host with
JAX, the save is restored, flattened to ``/``-joined paths and written with
``np.savez``, each ``None`` leaf (optax's empty states, ``optax.masked``'s
frozen leaves) as an empty array, so that the save's top keys all show
(the lines README.md shows, run where JAX is)::

    >>> import jax, numpy as np
    >>> from flax import serialization, traverse_util
    >>> from islam_tpu.utils.checkpoints import restore_checkpoint
    >>> state = jax.device_get(restore_checkpoint("models", 12))
    >>> flat = traverse_util.flatten_dict(
    ...     serialization.to_state_dict(state), sep="/")
    >>> np.savez("state.npz", **{k: np.zeros(0) if v is None
    ...                          else np.asarray(v) for k, v in flat.items()})

``trainer_state_from_jax`` turns that into what the port's
``Trainer.checkpoint_state()`` (or ``MultiSequenceTrainer``'s) holds:

- ``vo_variables`` -> ``model``, by ``state_dict_from_jax``'s rules;
- ``dn_params`` -> ``denoiser``, by ``denoiser_state_dict_from_jax``;
- ``vo_opt_state`` (``opt_state``) and ``imu_opt_state`` -> the port's
  optimizer states (``optim.py``), keyed like its parameters: optax's
  ``ScaleByAdamState(count, mu, nu)`` -> ``{"count", "mu", "nu"}``,
  ``ScaleByRmsState(nu)`` -> ``{"nu"}``, SGD's empty state -> ``{}``; the
  moments of a convolution or dense kernel are laid out as its parameter
  is (transposed with it).  ``optax.masked`` and ``optax.chain`` wrap the
  state in ``inner_state`` and tuple indices, which are skipped; the masked
  leaves are empty, so the moments cover the trainable parameters only, as
  the port's ``optim.trainable`` subset does;
- ``seq_states`` -> a list of ``{"pos", "rot", "vel"}`` float32 tensors.

A save without optimizer states (the JAX package's params-only saves)
gives a state without them, and the port's resume starts those optimizers
fresh, printing what it did not find, as the JAX package does.

Run:  python -m islam_tpu_torch.utils.jax_state STATE.npz SAVE_DIR EPOCH
writes ``SAVE_DIR/EPOCH/checkpoint.pt``; ``python -m islam_tpu_torch.train
--save-model-dir SAVE_DIR --start-epoch EPOCH+1 ...`` resumes from it.
"""

from __future__ import annotations

import argparse
from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from islam_tpu_torch.utils import checkpoints as ckpt
from islam_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                           flax_path_to_torch_key,
                                           grads_from_jax,
                                           state_dict_from_jax)

# the pose head's optimizer state: Trainer's key, MultiSequenceTrainer's
VO_OPT_KEYS = ("vo_opt_state", "opt_state")
_MOMENTS = ("mu", "nu")
_FIELDS = ("count",) + _MOMENTS


Entries = Dict[Tuple[str, ...], np.ndarray]


def _groups(flat: Mapping[str, np.ndarray]) -> Dict[str, Entries]:
    """{top key: {rest of the path: array}}."""
    out: Dict[str, Entries] = {}
    for key, value in flat.items():
        top, *rest = key.split("/")
        out.setdefault(top, {})[tuple(rest)] = np.asarray(value)
    return out


def _nested(entries: Entries) -> Dict:
    """Paths -> a nested dict, the empty arrays (``None`` leaves) left
    out."""
    tree: Dict = {}
    for path, value in entries.items():
        if value.size == 0:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def _pose_moment(path: Tuple[str, ...], value) -> Tuple[str, torch.Tensor]:
    full = ("params", "flowPoseNet") + path
    return flax_path_to_torch_key(full), grads_from_jax(full, value)


def _denoiser_moment(path: Tuple[str, ...], value) -> Tuple[str, torch.Tensor]:
    if path[0] == "decoder":
        path = ("pose_decoder",) + path[1:]
    return ".".join(path), torch.from_numpy(np.array(value, np.float32))


def optimizer_state_from_jax(entries: Entries, moment) -> Dict:
    """One optax state (paths under its top key) -> the port's optimizer
    state.  ``moment(param_path, array)`` gives a moment's key and tensor.
    A path's first ``count``/``mu``/``nu`` is the field; the segments
    before it (``inner_state``, chain indices) are wrappers."""
    state: Dict = {}
    for path, value in sorted(entries.items()):
        field = next((i for i, p in enumerate(path) if p in _FIELDS), None)
        if field is None:
            if value.size:
                raise ValueError(f"unknown optimizer state leaf "
                                 f"{'/'.join(path)}")
            continue  # an empty state (SGD's, chain's scale_by_lr)
        name, rest = path[field], path[field + 1:]
        if name == "count":
            state["count"] = int(value)
            continue
        moments = state.setdefault(name, {})
        if value.size:  # masked leaves are empty
            key, tensor = moment(rest, value)
            moments[key] = tensor
    return state


def trainer_state_from_jax(flat: Mapping[str, np.ndarray]) -> Dict:
    """The flat ``/``-joined arrays of a JAX ``Trainer`` or
    ``MultiSequenceTrainer`` save -> the port's checkpoint state."""
    groups = _groups(flat)
    unknown = set(groups) - {"vo_variables", "dn_params", "imu_opt_state",
                             "seq_states", *VO_OPT_KEYS}
    if unknown or "vo_variables" not in groups:
        raise KeyError(f"not a JAX trainer save: top keys {sorted(groups)}")
    state = {"model": state_dict_from_jax(_nested(groups["vo_variables"]))}
    for key in VO_OPT_KEYS:
        if key in groups:
            state["vo_opt_state"] = optimizer_state_from_jax(groups[key],
                                                             _pose_moment)
    if "dn_params" in groups:
        state["denoiser"] = denoiser_state_dict_from_jax(
            _nested(groups["dn_params"]))
    if "imu_opt_state" in groups:
        state["imu_opt_state"] = optimizer_state_from_jax(
            groups["imu_opt_state"], _denoiser_moment)
    if "seq_states" in groups:
        seqs = _nested(groups["seq_states"])
        state["seq_states"] = [
            OrderedDict((k, torch.from_numpy(np.array(seqs[i][k], np.float32)))
                        for k in ("pos", "rot", "vel"))
            for i in sorted(seqs, key=int)]
    return state


def convert(npz: str, save_dir: str, epoch: int) -> str:
    """``npz`` (the export above) -> ``save_dir/epoch/checkpoint.pt``;
    returns its path."""
    with np.load(npz) as flat:
        state = trainer_state_from_jax(dict(flat))
    return ckpt.save_checkpoint(save_dir, epoch, state)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="a JAX trainer save (flattened to .npz) -> "
                    "SAVE_DIR/EPOCH/checkpoint.pt")
    parser.add_argument("npz")
    parser.add_argument("save_dir")
    parser.add_argument("epoch", type=int)
    args = parser.parse_args(argv)
    path = convert(args.npz, args.save_dir, args.epoch)
    print(f"wrote {path}; resume with --save-model-dir {args.save_dir} "
          f"--start-epoch {args.epoch + 1}")
    return path


if __name__ == "__main__":
    main()
