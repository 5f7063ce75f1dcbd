"""Per-window losses of one 3-window unrolled 'vo' epoch, JAX package
against the port, on the CPU.

    python -m tests.test_torch_unrolled_windows [--modes unrolled implicit]

Not a test run by pytest (it defines no test): a check, kept as the
script behind the "unrolled loss growth" entry of ROADMAP.md Queue 3.  Both
packages run ``Trainer.run_epoch(1)`` ('vo') with ``--bilevel <mode>
--reproj-points 1 --frozen-bn-eval --fix-model-parts flow stereo`` and the
fifth factor at 0.5, at 64x128, B=2, on a synthetic trajectory of 7 frames
(3 windows), from one set of weights: the JAX initialiser's with
tests/test_torch_slice.py's constant heads and
tests/test_torch_bilevel_step.py's random BatchNorm running stats, and the
seed-1 denoiser.  It prints one JSON line per mode with both packages'
window losses and their largest relative difference, held against the
one-window test's tolerance (rtol 1e-3, tests/test_torch_bilevel_step.py).
Each JAX mode compiles its train step once: minutes on the CPU.
"""

import argparse
import json
import os
import tempfile

import jax
import numpy as np
import torch

from islam_tpu import testing as jtesting
from islam_tpu.arguments import get_args as jax_get_args
from islam_tpu.imu import denoiser as jdn
from islam_tpu.models import tartanvo as jtvo
from islam_tpu.train import Trainer as JaxTrainer
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                           state_dict_from_jax)

from tests.test_torch_bilevel_step import _with_running_stats
from tests.test_torch_slice import _with_constant_heads

H, W, B = 64, 128, 2
WINDOWS = 3
RTOL = 1e-3


def _flags(mode, pkl):
    return ["--data-type", "synthetic", "--image-height", str(H),
            "--image-width", str(W), "--batch-size", str(B),
            "--synthetic-frames", str(WINDOWS * B + 1), "--loss-weight",
            "(1,0.1,10,0.1,0.5)", "--rot-w", "1", "--trans-w", "0.1",
            "--print-interval", "0", "--bilevel", mode, "--reproj-points",
            "1", "--frozen-bn-eval", "--fix-model-parts", "flow", "stereo",
            "--imu-denoise-model-name", pkl]


def window_losses(mode, variables, pkl):
    """(JAX's, the port's) per-window losses of one 'vo' epoch."""
    jtr = JaxTrainer(jax_get_args(_flags(mode, pkl)), jtesting.make_dataset(
        num_frames=WINDOWS * B + 1, height=H, width=W))
    jtr.vo_variables = variables
    jtr.vo_opt_state = jtr.vo_opt.init(variables["params"]["flowPoseNet"])
    jtr.run_epoch(1)
    ds = SyntheticTrajDataset(num_frames=WINDOWS * B + 1, height=H, width=W,
                              transform=ttrain.make_transform(H, W))
    ttr = ttrain.Trainer(get_args([*_flags(mode, pkl), "--device", "cpu"]),
                         ds, device="cpu",
                         state_dict=state_dict_from_jax(variables))
    ttr.run_epoch(1)
    return jtr.last_epoch_losses, ttr.window_losses[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modes", nargs="+", default=["unrolled"])
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    variables = _with_running_stats(_with_constant_heads(jax.device_get(
        jtvo.init_params(jax.random.PRNGKey(0), H, W))))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "denoiser.pkl")
        torch.save(denoiser_state_dict_from_jax(jax.device_get(
            jdn.init_params(jax.random.PRNGKey(1)))), pkl)
        for mode in a.modes:
            jl, tl = window_losses(mode, variables, pkl)
            rel = float(np.max(np.abs(np.subtract(tl, jl))
                               / np.abs(jl)))
            row = {"mode": mode, "jax": jl, "port": tl,
                   "max_rel_diff": rel, "rtol": RTOL,
                   "within_rtol": rel <= RTOL}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
