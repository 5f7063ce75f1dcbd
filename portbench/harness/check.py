"""``correct``: what the timed path produced, against the plain reference.

The reference (``portbench/ref``) gets the drive's files and the seed's
weights and works out again every window it checks: the images from the
PNGs, the VO networks on the card in float32 with TF32 off, the scale and
frame conversions in float64, the denoiser on the card in float32, the
preintegration sample by sample and the pose graph by the PyPose replica
in float64 on the host.

Each checked window starts from the state the program carried into it (its
previous window's last PVGO pose and velocity, or the slice's first
ground-truth state): the reference follows the program step by step, and
the carry is checked by the IMU integration that starts from it.  Which
windows: ``CHECKED_WINDOWS`` of the timed epoch, the last one and others
drawn from the seed, in every cell.  In 'vo' cells the reference also
follows the three set-up steps (each window's loss and gradient, Adam's
update): the windows of the first step are compared, with the first
gradient (from Adam's first moment after step 1) and the change of the
parameters after step 3.  The VO motions are compared only where both
sides hold the same weights: in the first step's windows, and in every
checked window of a serving cell.  From the second step on the two sides'
pose heads part by Adam's rounding (an element whose gradient is near zero
moves by +-lr whichever way rounding tips it), so in a 'vo' cell's timed
windows the reference runs no VO: it checks the IMU stage from the
program's carry and the PVGO stage on the program's own motions, neither
of which reads the pose head (PERF.md).

The numbers, over the checked windows (a cell compares those its file in
``cells/`` gives a limit):

- ``rot_gap``: the VO motions' worst rotation error over their median
  rotation angle, or over ``ROT_FLOOR`` where that is larger;
- ``trans_gap``: the 90th percentile over the compared pairs of the
  translation error, over the median translation or ``TRANS_FLOOR``: a
  pair's metric scale (a least-squares ratio over masked pixels) can part
  between two float32 computations by 1e-3 on its own, once in some dozens
  of runs, where TF32 moves every pair's;
- ``imu_gap``: the IMU poses' position error over the median distance
  between frames, or the rotation error over the median orientation
  angle, whichever is larger;
- ``pgo_gap``: the PVGO poses and velocities, in the solve's own metric
  (``pgo_gap``);
- ``loss_gap``: |loss - reference| / |reference| of each window of the
  first step ('vo');
- ``grad_gap``, ``change_gap``: by the worst leaf, |program norm -
  reference norm| over the larger of the reference's norm of that leaf and
  of the median leaf; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out of the change.

``control`` puts the reference itself in the program's place, computed
one precision below the configuration's float32 (``Reference``): the
numbers it gives are upper readings of the limits.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.ref import imu, lie, nets, pvgo, vo

ADAM = (0.9, 0.999, 1e-8)
CHECKED_WINDOWS = 4   # timed windows compared: the last, the rest from the seed
# The scales under which the VO motions' gaps are not divided further: the
# float32 frame conversions round a motion by ~2e-7 rad whatever its size,
# and a seed whose random pose head barely turns (0.001 rad a frame) would
# read that rounding as a gap of 1e-4; 0.01 rad and 0.01 m are a slow
# frame pair of the flights and drives.
ROT_FLOOR = 0.01
TRANS_FLOOR = 0.01


def flags(preset):
    """{flag: [values]} of a command line's flags."""
    out, key = {}, None
    for word in preset:
        if word.startswith("--"):
            key = word[2:]
            out[key] = []
        elif key is not None:
            out[key].append(word)
    return out


class Reference:
    """The reference over one drive with the seed's weights.  ``control``
    computes it one precision below the configuration's float32, by the
    kind of work: the networks' convolutions and products in TF32 (the
    tensor cores' float32), the IMU stage (the denoiser and the
    integration, whose work TF32 does not touch) in bfloat16."""

    def __init__(self, cell, root, sd, dn_sd, device, control=False):
        cfg = cell.config
        self.B, self.tf32, self.device = cfg["batch_size"], control, device
        self.imu_dtype = torch.bfloat16 if control else torch.float64
        self.datatype = cfg["datatype"]
        self.drive = vo.Drive(root, self.datatype, cfg["image_height"],
                              cfg["image_width"])
        self.seq = self.drive.seq
        self.net = nets.VONet(cfg["image_height"], cfg["image_width"])
        self.net.load_state_dict({k: v.detach().clone()
                                  for k, v in sd.items()})
        self.net.to(device)
        self.dn = imu.Denoiser(dn_sd, device, torch.bfloat16 if control
                               else torch.float32)
        f = flags(cfg["preset"])
        self.w = [float(x) for x in
                  f["loss-weight"][0].strip("()").split(",")][:4]
        self.rot_w, self.trans_w = (float(f["rot-w"][0]),
                                    float(f["trans-w"][0]))
        self.lr = float(f["lr"][0])
        self.edges = torch.tensor([[i, i + 1] for i in range(self.B)])

    def pose_params(self):
        return {k: p for k, p in self.net.named_parameters()
                if k.startswith("flowPoseNet.")}

    def window(self, st, start, grad=False, judged=None, with_vo=True):
        """Frames st .. st + B from ``start`` = (pos, quat, vel): the
        window's motions, IMU states, PVGO solution and (``grad``) the loss
        with its graph to the pose head.  With ``judged`` (a window of the
        side being judged) the solve is also made from that side's VO
        motions and this IMU (``judged_pvgo``): the stage's own answer to
        the motions the program gave it; without ``with_vo`` (and with
        ``judged``) that is all, the IMU states and that solve."""
        B, seq = self.B, self.seq
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            m = None
            if with_vo:
                inp = self.drive.window(st, B, self.device)
                with torch.set_grad_enabled(grad):
                    m, _ = vo.motions(self.net, inp, self.datatype,
                                      seq.rgb2imu_pose)
            dts, gy, ac, ends = imu.window_samples(seq, st, B)
            I = imu.integrate(dts, gy, ac, ends, start, seq.gravity, self.dn,
                              denoise_accel=True,
                              denoise_gyro=self.datatype != "kitti",
                              dtype=self.imu_dtype)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        nodes0 = torch.cat([I["pos"], I["rot"]], dim=1)
        dts = np.asarray(seq.rgb_dts[st:st + B], np.float64)

        def solve(motions):
            prob = pvgo.Problem(self.edges, motions, I["drot"], I["dpos"],
                                I["dvel"], dts, self.w)
            sol = prob.solve(nodes0.numpy(), I["vel"].numpy())
            nodes, vels = pvgo.align_to(sol.nodes, sol.vels, nodes0[0])
            return {"problem": prob, "nodes": nodes, "vels": vels}

        out = {"imu_poses": nodes0[1:].numpy()}
        if m is not None:
            out["motions"] = m.detach().cpu().numpy()
        if judged is not None:
            out["judged_pvgo"] = solve(np.asarray(judged["motions"]))
        if grad or judged is None:
            own = solve(m.detach().cpu())
            out.update(pgo_poses=own["nodes"][1:].numpy(),
                       pgo_vels=own["vels"][1:].numpy())
        if grad:
            out["loss"] = pvgo.vo_loss(own["nodes"].to(self.device),
                                       self.edges, m, self.rot_w,
                                       self.trans_w)
        return out

    def adam(self):
        params = self.pose_params()
        b1, b2, eps = ADAM
        state = {"t": 0, "m": {k: torch.zeros_like(p) for k, p in
                               params.items()},
                 "v": {k: torch.zeros_like(p) for k, p in params.items()}}

        @torch.no_grad()
        def step(grads):
            state["t"] += 1
            t = state["t"]
            # optax forms the bias corrections in float32
            c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(t))
                      for b in (b1, b2))
            for k, p in params.items():
                g = grads[k]
                state["m"][k] = b1 * state["m"][k] + (1 - b1) * g
                state["v"][k] = b2 * state["v"][k] + (1 - b2) * g * g
                p.add_(-self.lr * (state["m"][k] / c1)
                       / (torch.sqrt(state["v"][k] / c2) + eps))
        return step


def follow(ref, cell, prog, seed, judged=None):
    """The reference's run beside the program's ``prog``: the same windows
    from the same starts, each compared one also solved from the VO motions
    of ``judged`` (a run of the same shape: the program's, or the
    control's).  Returns a dict of that shape."""
    B = ref.B
    out = {"warm": []}
    if cell.traffic["target"] == "vo":
        params = ref.pose_params()
        p0 = {k: p.detach().clone() for k, p in params.items()}
        step = ref.adam()
        for warm in prog["warm"]:
            first = warm["first"]
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            wins, losses = [], []
            for w, pw in enumerate(warm["out"]):
                jw = (judged["warm"][0]["out"][w]
                      if judged is not None and not out["warm"] else None)
                r = ref.window(first + w * B, pw["start"], grad=True,
                               judged=jw)
                gs = torch.autograd.grad(r["loss"], list(params.values()),
                                         allow_unused=True)
                for (k, p), g in zip(params.items(), gs):
                    if g is not None:
                        grads[k] += g
                losses.append(float(r["loss"].detach()))
                wins.append(r)
            if not out["warm"]:
                out["grad1"] = {k: g.double().cpu() for k, g in grads.items()}
            step(grads)
            out["warm"].append({"losses": losses, "out": wins})
        out["change"] = {k: (p.detach() - p0[k]).double().cpu()
                         for k, p in params.items()}
    # the pose heads of a 'vo' cell have parted by its timed epoch: the
    # side that judges runs no VO there
    with_vo = judged is None or cell.traffic["target"] != "vo"
    out["timed"] = {}
    for w in checked_windows(prog, seed):
        st = prog["timed_start"] + w * B
        out["timed"][w] = ref.window(
            st, prog["timed"][w]["start"],
            judged=None if judged is None else judged["timed"][w],
            with_vo=with_vo)
    return out


def checked_windows(prog, seed):
    """The timed epoch's last window and others drawn from the seed."""
    n = len(prog["timed"])
    rng = np.random.default_rng([seed, 7])
    others = rng.choice(n - 1, size=min(CHECKED_WINDOWS, n) - 1,
                        replace=False)
    return sorted({n - 1, *(int(x) for x in others)})


def _angle(q):
    return 2 * np.arctan2(np.linalg.norm(q[..., :3], axis=-1),
                          np.abs(q[..., 3]))


def _rel_quat(a, b):
    """a^-1 b of (..., 4) quaternions (x, y, z, w), float64."""
    return lie.quat_mul(lie.quat_conj(torch.as_tensor(a)),
                        torch.as_tensor(b)).numpy()


def _pose_gap(p, r):
    """IMU poses (n, 7): the position error over the median distance
    between frames, or the rotation error over the median angle of the
    reference's orientations, whichever is larger."""
    d = np.linalg.norm(np.diff(r[:, :3], axis=0), axis=1)
    pos = np.linalg.norm(p[:, :3] - r[:, :3], axis=1).max()
    rot = _angle(_rel_quat(r[:, 3:], p[:, 3:])).max()
    return max(pos / max(np.median(d), 1e-12),
               rot / max(np.median(_angle(r[:, 3:])), 1e-12))


def pgo_gap(p, r):
    """The program's PVGO solution against the reference's solve of the
    same VO motions (``judged_pvgo``), in that problem's own metric: with J
    and r the weighted residual's Jacobian and value at the reference's
    solution and Delta the tangent from it to the program's (Exp(xi) o T
    for each pose after the window's first, v for each velocity),
    sqrt(Delta' J'J Delta / r'r): the linearised rise of the solve's cost,
    relative to its cost.  A direction the problem barely determines (the
    velocities, weighed 0.1 at dt 0.1 s) counts as little as it costs, so
    the gap follows the solve's own error and the IMU's, not the
    problem's conditioning; the VO motions it is given are the
    ``rot_gap`` and ``trans_gap``'s to judge."""
    r = r["judged_pvgo"]
    nodes, vels = r["nodes"], r["vels"]
    pn = torch.as_tensor(np.asarray(p["pgo_poses"], np.float64))
    xi = lie.se3_log(lie.se3_mul(pn, lie.se3_inv(nodes[1:])))
    dv = torch.as_tensor(np.asarray(p["pgo_vels"], np.float64)) - vels[1:]
    N = nodes.shape[0]
    delta = torch.zeros(9 * N, dtype=torch.float64)
    delta[6:6 * N] = xi.reshape(-1)
    delta[6 * N + 3:] = dv.reshape(-1)
    prob = r["problem"]
    J = prob.jacobian(nodes, vels)
    res = prob.r(nodes, vels)
    return float(torch.sqrt((J @ delta).square().sum() / (res @ res)))


def _leaf_gap(prog, ref, keep=None):
    norms_r = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(norms_r.values())
    gaps = [abs(float(prog[k].norm()) - norms_r[k]) / max(norms_r[k], med)
            for k in ref if keep is None or k in keep]
    return max(gaps) if gaps else 0.0


def compare(prog, ref, cell):
    """The numbers, each (name, value), over the checked windows."""
    # (program window, reference window): the first step's windows, where
    # both sides hold the seed's weights, and the timed windows checked
    pairs, losses = [], []
    if prog["warm"]:
        pairs += list(zip(prog["warm"][0]["out"], ref["warm"][0]["out"]))
        losses += list(zip(prog["warm"][0]["losses"],
                           ref["warm"][0]["losses"]))
    pairs += [(prog["timed"][w], r) for w, r in ref["timed"].items()]
    rot_err, rot_ref, tr_err, tr_ref = [], [], [], []
    imu_gap, pgo = 0.0, 0.0
    for p, r in pairs:
        imu_gap = max(imu_gap, _pose_gap(p["imu_poses"], r["imu_poses"]))
        pgo = max(pgo, pgo_gap(p, r))
        if "motions" not in r:
            continue
        rot_err.append(_angle(_rel_quat(r["motions"][:, 3:],
                                        p["motions"][:, 3:])))
        rot_ref.append(_angle(r["motions"][:, 3:]))
        tr_err.append(np.linalg.norm(p["motions"][:, :3]
                                     - r["motions"][:, :3], axis=1))
        tr_ref.append(np.linalg.norm(r["motions"][:, :3], axis=1))
    rot_err, rot_ref, tr_err, tr_ref = (np.concatenate(x) for x in (
        rot_err, rot_ref, tr_err, tr_ref))
    out = [("rot_gap", float(rot_err.max()
                             / max(np.median(rot_ref), ROT_FLOOR))),
           ("trans_gap", float(np.percentile(tr_err, 90)
                               / max(np.median(tr_ref), TRANS_FLOOR))),
           ("imu_gap", float(imu_gap)),
           ("pgo_gap", float(pgo))]
    if losses:
        out.append(("loss_gap", max(abs(a - b) / abs(b) for a, b in losses)))
        g1r = ref["grad1"]
        norms = {k: float(v.norm()) for k, v in g1r.items()}
        med = statistics.median(norms.values())
        moving = {k for k, n in norms.items() if n >= 1e-3 * med}
        out.append(("grad_gap", _leaf_gap(prog["grad1"], g1r)))
        out.append(("change_gap", _leaf_gap(prog["change"], ref["change"],
                                            moving)))
    return [(k, v if math.isfinite(v) else float("inf")) for k, v in out]


def run(cell, root, sd, dn_sd, prog, seed, device, control=False):
    """The compared numbers of one run: [(name, value)]; with ``control``,
    those of the control (``Reference``) in the program's place."""
    judged = prog
    if control:
        judged = follow(Reference(cell, root, sd, dn_sd, device,
                                  control=True), cell, prog, seed)
    ref = follow(Reference(cell, root, sd, dn_sd, device), cell, prog, seed,
                 judged)
    return compare(judged, ref, cell)
