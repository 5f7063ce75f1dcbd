"""Shared pieces of the benchmark's tests: the repository's root on the
path, and the cells cut to 64x128, B=2 on small drives."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("kitti-f32-vo", "euroc-f32-eval")


def tiny(name):
    """The cell ``name`` at 64x128, B=2, on a 160x96 drive, with the
    fewest timed windows."""
    from portbench.harness import spec
    c = spec.load(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(image_height=64, image_width=128, batch_size=2)
    # at 64x128 a scaled-down rotation head turns ~1e-4 rad a frame and
    # the scale fitted to it moves the frames by ~1e-3 m, under the
    # comparison's floors (check.ROT_FLOOR, TRANS_FLOOR): its gain stays 1
    cfg["weights"] = {k: v for k, v in cfg["weights"].items()
                      if k != "rot_head_gain"}
    d = cfg["drive"]
    d.update(width=160, height=96)
    if cfg["datatype"] == "kitti":
        d["calib"].update(fx=92.0, cx=80.0, cy=48.0, p2_tx=6.0, p3_tx=-43.0)
    else:
        d["calib"]["cam0_intrinsics"] = [96.0, 96.0, 80.0, 48.0]
        d["calib"]["cam1_intrinsics"] = [96.0, 96.0, 80.5, 48.2]
    return c._replace(config=cfg, spec=dict(c.spec, windows_per_s=0.0))
