"""Imperative SLAM loop, eval-only slice: VO forward -> IMU preintegration
-> PVGO per window, with the state carried from window to window.

Counterpart of ``islam_tpu/train.py`` for epoch 0 of the schedule, whose
target is '' (inference: no gradients, no updates), which is what
``--eval-only`` runs.  The 'vo'/'imu' training targets, their optimizers and
the fused multi-window scan come with a later slice.

Run:  python -m islam_tpu_torch.train --eval-only --data-type synthetic \\
          --image-height 448 --image-width 640 --batch-size 8 \\
          --synthetic-frames 25 --loss-weight '(1,0.1,10,0.1)' \\
          --rot-w 1 --trans-w 0.1 --result-dir results/eval
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from islam_tpu_torch import lie
from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.imu.module import IMUModule, integrate_window
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.models import tartanvo as tvo
from islam_tpu_torch.pvgo.run import run_pvgo

MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


def make_transform(height: int, width: int):
    """The sample pipeline ``main`` builds (train.py:797-803)."""
    from islam_tpu_torch.data.transforms import (Compose, CropCenter,
                                                 DownscaleFlow, Normalize,
                                                 ToNHWCTensor)
    return Compose([
        CropCenter((height, width), fix_ratio=True),
        DownscaleFlow(),
        Normalize(mean=MEAN, std=STD, keep_old=True),
        ToNHWCTensor(),
    ])


def device_batch(sample: Dict, current_idx: int, device) -> Dict:
    """Window arrays -> device tensors (islam_tpu/testing.py:48-65).

    Consecutive-pair windows share a frame between adjacent pairs, so the
    B+1 distinct frames go along as ``frames`` and the flow pyramid runs
    once per frame."""
    b = {k: torch.from_numpy(np.asarray(sample[k])).to(device)
         for k in ("img0", "img1", "img0_norm", "img0_r_norm", "intrinsic",
                   "intrinsic_calib", "extrinsic", "motion") if k in sample}
    links = np.asarray(sample["link"]) - current_idx
    b["links"] = torch.from_numpy(links).to(device)
    b["dts"] = torch.from_numpy(np.asarray(sample["dt"], np.float32)).to(device)
    if np.array_equal(links[:, 1], links[:, 0] + 1) and np.array_equal(
            links[:, 0], np.arange(len(links))):
        frames = np.concatenate([sample["img0"], sample["img1"][-1:]])
        b["frames"] = torch.from_numpy(frames).to(device)
    return b


def infer_step(model, batch, imu_win, init_state, rgb2imu_pose, gravity,
               accel_bias, gyro_bias, subtract_bias, datatype="kitti",
               use_kitti_coord=True, denoise_accel=True, denoise_gyro=True,
               loss_weight=(1., 1., 1., 1.), rot_w=1.0, trans_w=1.0):
    """One window of B frame-pairs with nothing trainable (target '').
    Returns (loss, aux) as the JAX step's ``compute`` does."""
    baseline = torch.linalg.norm(batch["extrinsic"][:, :3], dim=1)
    res = tvo.forward(
        model, batch["img0"], batch["img1"], batch["img0_norm"],
        batch["img0_r_norm"], batch["intrinsic"], batch["intrinsic_calib"],
        baseline, frames=batch.get("frames"), datatype=datatype,
        use_kitti_coord=use_kitti_coord)
    # camera -> IMU frame conjugation (train.py:214-215)
    T_IL = rgb2imu_pose
    motions = lie.se3_mul(T_IL[None],
                          lie.se3_mul(res["motion"], lie.se3_inv(T_IL)[None]))

    imu = integrate_window(None, *imu_win, init_state, gravity, accel_bias,
                           gyro_bias, subtract_bias,
                           denoise_accel=denoise_accel,
                           denoise_gyro=denoise_gyro)
    imu_poses = torch.cat([imu["pos"], imu["rot"]], dim=1)

    trans_loss, rot_loss, pgo_poses, pgo_vels, _ = run_pvgo(
        imu_poses, imu["vel"], motions, batch["links"], batch["dts"],
        imu["drot"], imu["dpos"], imu["dvel"], radius=1e4,
        loss_weight=loss_weight, target="")

    loss = torch.sum(rot_w * rot_loss) + torch.sum(trans_w * trans_loss)
    tail_q = pgo_poses[-1, 3:]
    carry = IMUState(pos=pgo_poses[-1, :3], rot=tail_q / torch.linalg.norm(
        tail_q), vel=pgo_vels[-1])
    aux = {"motions": motions.detach(), "imu_poses": imu_poses,
           "imu_vels": imu["vel"], "pgo_poses": pgo_poses,
           "pgo_vels": pgo_vels, "trans_loss": torch.sum(trans_loss),
           "rot_loss": torch.sum(rot_loss), "carry": carry}
    return loss, aux


def train_step(model, batch, imu_win, init_state, rgb2imu_pose, gravity,
               accel_bias, gyro_bias, subtract_bias, target="", **kw):
    """The ``target=''`` branch of the JAX ``train_step``: the inference
    window under ``torch.no_grad``, with the nonfinite guard.  Returns
    (loss, None, aux)."""
    if target:
        raise NotImplementedError(f"target {target!r}: training targets "
                                  "come with the next slice")
    with torch.no_grad():
        loss, aux = infer_step(model, batch, imu_win, init_state,
                               rgb2imu_pose, gravity, accel_bias, gyro_bias,
                               subtract_bias, **kw)
    return loss, None, _guard_nonfinite(loss, aux, init_state)


def _guard_nonfinite(loss, aux, init_state):
    """Bad-window containment: if the loss is nonfinite, the carry falls back
    to the window's init state, on the device.  ``aux['ok']`` reports it.
    (The JAX guard also zeroes nonfinite gradients; no gradients exist yet.)
    """
    ok = torch.isfinite(loss)
    aux = dict(aux)
    aux["carry"] = IMUState(*(torch.where(ok, c, i)
                              for c, i in zip(aux["carry"], init_state)))
    aux["ok"] = ok
    return aux


class Trainer:
    """Owns dataset iteration, the state carry and the snapshots."""

    def __init__(self, args, dataset, device="cuda", state_dict=None):
        self.args = args
        self.dataset = dataset
        self.device = torch.device(device)
        h, w = dataset[0]["img0"].shape[:2]
        self.model = tvo.init_model(h, w, seed=0, device=self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.imu_module = IMUModule(
            dataset.accels, dataset.gyros, dataset.imu_dts,
            dataset.accel_bias, dataset.gyro_bias, gravity=dataset.gravity,
            rgb2imu_sync=dataset.rgb2imu_sync,
            denoise_accel=True, denoise_gyro=(dataset.datatype != "kitti"),
            batch_frames=args.batch_size, device=self.device)
        self.rgb2imu_pose = torch.tensor(np.asarray(dataset.rgb2imu_pose),
                                         dtype=torch.float32,
                                         device=self.device)
        self.train_target = [""] + ["vo", "imu"] * 100
        # Wall time of each window (device synced) and of its host-side
        # sample preparation (load, transforms, collate, copy to device).
        self.window_seconds = []
        self.prep_seconds = []

    def _state(self, init: Dict) -> IMUState:
        return IMUState(*(torch.tensor(np.asarray(init[k]), dtype=torch.float32,
                                       device=self.device)
                          for k in ("pos", "rot", "vel")))

    def run_epoch(self, epoch, snapshot_dir=None, snapshot_interval=None):
        target = self.train_target[epoch]
        if target:
            raise NotImplementedError(f"epoch {epoch} (target {target!r}): "
                                      "training epochs: next slice")
        args = self.args
        B = args.batch_size
        n_batches = len(self.dataset) // B
        traj = _TrajLogs(self.dataset.imu_init)
        init_state = self._state(self.dataset.imu_init)
        pending = []
        bad_windows = 0
        subtract_bias = torch.tensor(self.imu_module.optm_bias,
                                     device=self.device)

        def flush():
            nonlocal bad_windows
            for a in pending:
                m, pg, pv, ip = (a[k].cpu().numpy() for k in (
                    "motions", "pgo_poses", "pgo_vels", "imu_poses"))
                bad_windows += int(not bool(a["ok"]))
                traj.extend(m, pg, pv, ip)
            pending.clear()

        for bi in range(n_batches):
            t0 = time.perf_counter()
            current_idx = bi * B
            sample = collate([self.dataset[i]
                              for i in range(current_idx, current_idx + B)])
            batch = device_batch(sample, current_idx, self.device)
            imu_win = self.imu_module.window_inputs(current_idx,
                                                    current_idx + B)
            self.prep_seconds.append(time.perf_counter() - t0)
            loss, _, aux = train_step(
                self.model, batch, imu_win, init_state, self.rgb2imu_pose,
                self.imu_module.gravity, self.imu_module.accel_bias,
                self.imu_module.gyro_bias, subtract_bias, target=target,
                datatype=self.dataset.datatype, use_kitti_coord=True,
                denoise_accel=True,
                denoise_gyro=(self.dataset.datatype != "kitti"),
                loss_weight=tuple(float(w) for w in args.loss_weight),
                rot_w=args.rot_w, trans_w=args.trans_w)
            # ---- state carry stays on the device (train.py:296-299) ----
            init_state = aux["carry"]
            pending.append(aux)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.window_seconds.append(time.perf_counter() - t0)

            if snapshot_dir and (bi < 10 or (
                    snapshot_interval and (bi + 1) % snapshot_interval == 0)):
                flush()
                traj.save(snapshot_dir, epoch)
            if args.print_interval and (bi + 1) % args.print_interval == 0:
                print(f"[step {bi + 1}/{n_batches}] target={target} "
                      f"loss={float(loss):.6f} "
                      f"step={self.window_seconds[-1]:.3f}s")

        flush()
        if bad_windows:
            print(f"WARNING: {bad_windows} window(s) produced a nonfinite "
                  "loss; their state carries were reset (aux['ok'])")
        if snapshot_dir:
            traj.save(snapshot_dir, epoch)
        return traj


class _TrajLogs:
    """Trajectory recording + np.savetxt snapshots (train.py:51-61)."""

    def __init__(self, init_state):
        init_pose = np.concatenate([init_state["pos"], init_state["rot"]])
        self.vo_motions = []
        self.vo_poses = [init_pose]
        self.pgo_motions = []
        self.pgo_poses = [init_pose]
        self.pgo_vels = [np.asarray(init_state["vel"])]
        self.imu_poses = [init_pose]
        self.imu_motions = []

    def extend(self, motions, pgo_poses, pgo_vels, imu_poses):
        self.vo_motions.extend(motions)
        T = _se3_np(self.vo_poses[-1])
        for m in motions:
            T = T @ _se3_np(m)
            self.vo_poses.append(_se3_flat(T))
        for i in range(1, len(pgo_poses)):
            self.pgo_poses.append(pgo_poses[i])
            self.pgo_vels.append(pgo_vels[i])
            self.pgo_motions.append(_se3_flat(
                np.linalg.inv(_se3_np(pgo_poses[i - 1]))
                @ _se3_np(pgo_poses[i])))
        for i in range(1, len(imu_poses)):
            self.imu_poses.append(imu_poses[i])
            self.imu_motions.append(_se3_flat(
                np.linalg.inv(_se3_np(imu_poses[i - 1]))
                @ _se3_np(imu_poses[i])))

    def save(self, trainroot, epoch):
        d = f"{trainroot}/{epoch}"
        os.makedirs(d, exist_ok=True)
        np.savetxt(f"{d}/vo_pose.txt", np.stack(self.vo_poses))
        np.savetxt(f"{d}/pgo_pose.txt", np.stack(self.pgo_poses))
        np.savetxt(f"{d}/pgo_vel.txt", np.stack(self.pgo_vels))
        np.savetxt(f"{d}/imu_pose.txt", np.stack(self.imu_poses))
        if self.vo_motions:
            np.savetxt(f"{d}/vo_motion.txt", np.stack(self.vo_motions))
        if self.pgo_motions:
            np.savetxt(f"{d}/pgo_motion.txt", np.stack(self.pgo_motions))
        if self.imu_motions:
            np.savetxt(f"{d}/imu_motion.txt", np.stack(self.imu_motions))


def _se3_np(p):
    T = np.eye(4)
    T[:3, :3] = R.from_quat(np.asarray(p[3:])).as_matrix()
    T[:3, 3] = np.asarray(p[:3])
    return T


def _se3_flat(T):
    q = R.from_matrix(T[:3, :3]).as_quat()
    return np.concatenate([T[:3, 3], q]).astype(np.float32)


def main(argv=None):
    """``--eval-only`` entry point; returns the Trainer after the pass."""
    from islam_tpu_torch.arguments import get_args
    from islam_tpu_torch.data.synthetic import SyntheticTrajDataset

    args = get_args(argv)
    if not args.eval_only:
        raise NotImplementedError("training epochs: next slice")
    print(args)
    # The preset runs in float32: cuDNN's default TF32 convolutions would
    # keep only ~3 decimal digits.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dataset = SyntheticTrajDataset(
        num_frames=args.synthetic_frames, height=args.image_height,
        width=args.image_width,
        transform=make_transform(args.image_height, args.image_width))
    trainer = Trainer(args, dataset, device=args.device)

    trainroot = args.result_dir or "."
    if args.result_dir:
        os.makedirs(trainroot, exist_ok=True)
        with open(trainroot + "/args.txt", "w") as f:
            f.write(str(args))
        np.savetxt(trainroot + "/gt_pose.txt", dataset.poses)
        np.savetxt(trainroot + "/timestamp.txt", dataset.rgb_ts, fmt="%.3f")

    t0 = time.time()
    trainer.run_epoch(0, snapshot_dir=args.result_dir or None,
                      snapshot_interval=args.snapshot_interval)
    print(f"eval-only pass time={time.time() - t0:.1f}s "
          f"(snapshots under {trainroot}/0)")
    return trainer


if __name__ == "__main__":
    main()
