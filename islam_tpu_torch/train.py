"""Imperative SLAM loop: VO forward -> IMU preintegration -> PVGO per window,
with the state carried from window to window, and the training epochs.

Counterpart of ``islam_tpu/train.py``.  The schedule is the reference's,
[''] + ['vo', 'imu'] * 100: epoch 0 (target '', ``--eval-only``) infers;
'vo' epochs differentiate the pose head (``flowPoseNet``) through the
detached PVGO's VO loss, 'imu' epochs the IMU denoiser through its IMU loss,
with the VO motions replayed from the previous epoch.  Gradients are summed
over an epoch's windows on the device and applied once at its end
(train.py:172-179).  ``--bilevel implicit|unrolled`` carries the 'vo'
gradient through the PVGO solve as well, ``--reproj-points`` adds the dense
reprojection factor to it, and ``--frozen-bn-eval`` runs a frozen stereo
net's BatchNorms on their running stats, and ``--bf16`` runs the VO networks
in bfloat16.  A worker thread prepares the next window while the card runs
the current one (``Prefetcher``).  ``--scan-chunk K`` runs a training
epoch's windows K at a time through ``train_scan``, which reads nothing back
to the host between them.  ``--save-model-dir`` saves every epoch and, with
``--start-epoch``, resumes.  ``--profile-dir`` writes a ``torch.profiler``
trace of the second window.

Run:  python -m islam_tpu_torch.train --data-type kitti --data-root SEQ \\
          --vo-model-name stereo_flow_pose.pkl --pose-model-name pose.pkl \\
          --imu-denoise-model-name denoiser.pkl --save-model-dir models \\
          --result-dir results/train --worker-num 2 \\
          --fix-model-parts flow stereo --batch-size 8 --train-epoch 2 \\
          --loss-weight '(1,0.1,10,0.1)' --rot-w 1 --trans-w 0.1
(``--data-type synthetic`` for generated data, ``--eval-only`` for the
inference pass alone, ``--device cpu`` off the card.)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R
from torch.profiler import record_function

from islam_tpu_torch import lie, optim
from islam_tpu_torch.imu.denoiser import IMUDenoiser
from islam_tpu_torch.imu.module import IMUModule, integrate_window
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.models import tartanvo as tvo
from islam_tpu_torch.ops.dense_ba import DenseReprojectionLoss
from islam_tpu_torch.pvgo.run import run_pvgo
from islam_tpu_torch.utils import checkpoints as ckpt

MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
# --fix-model-parts names -> pose-head parameter prefixes (train.py:337-338);
# 'flow' and 'stereo' are never trained, so they need no entry.
POSE_FIX = {"feat": "flowPoseNet.feat_net.", "rot": "flowPoseNet.voflow_rot.",
            "trans": "flowPoseNet.voflow_trans."}


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


def device_batch(sample: Dict, current_idx: int, device,
                 pin: bool = False) -> Dict:
    """Window arrays -> device tensors (islam_tpu/testing.py:48-65).

    Consecutive-pair windows share a frame between adjacent pairs, so the
    B+1 distinct frames go along as ``frames`` and the flow pyramid runs
    once per frame.  ``pin`` copies through pinned host memory, without
    blocking the host, on the current stream."""
    def to(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory().to(device, non_blocking=True) if pin else (
            t.to(device))

    b = {k: to(sample[k])
         for k in ("img0", "img1", "img0_norm", "img0_r_norm", "intrinsic",
                   "intrinsic_calib", "extrinsic", "motion") if k in sample}
    links = np.asarray(sample["link"]) - current_idx
    b["links"] = to(links)
    b["dts"] = to(np.asarray(sample["dt"], np.float32))
    if np.array_equal(links[:, 1], links[:, 0] + 1) and np.array_equal(
            links[:, 0], np.arange(len(links))):
        b["frames"] = to(np.concatenate([sample["img0"],
                                         sample["img1"][-1:]]))
    return b


class Prefetcher:
    """One-deep keyed background prefetch with exception propagation
    (``islam_tpu/train.py:262-297``).

    ``start(k)`` computes ``fn(k)`` on a worker thread; ``take(k)`` joins
    and returns the result, or raises with the worker's exception chained,
    so a failing loader surfaces its own error."""

    def __init__(self, fn):
        self._fn = fn
        self._slots = {}
        self._threads = {}

    def start(self, key):
        def run():
            try:
                self._slots[key] = (True, self._fn(key))
            except BaseException as e:  # noqa: BLE001 - re-raised in take()
                self._slots[key] = (False, e)

        t = threading.Thread(target=run, daemon=True)
        self._threads[key] = t
        t.start()

    def pending(self, key) -> bool:
        return key in self._threads

    def take(self, key):
        self._threads.pop(key).join()
        ok, value = self._slots.pop(key)
        if not ok:
            raise RuntimeError(f"prefetch of item {key} failed") from value
        return value


def pose_params(model) -> Dict[str, torch.Tensor]:
    """The pose head's parameters, by state_dict key: what 'vo' trains."""
    return {k: p for k, p in model.named_parameters()
            if k.startswith("flowPoseNet.")}


def window_loss(model, batch, imu_win, init_state, rgb2imu_pose, gravity,
                accel_bias, gyro_bias, subtract_bias, target="",
                denoiser=None, prev_motions=None, datatype="kitti",
                use_kitti_coord=True, correct_scale=False, denoise_accel=True,
                denoise_gyro=True, loss_weight=(1., 1., 1., 1.), rot_w=1.0,
                trans_w=1.0, bilevel="detached", use_reproj=False,
                frozen_bn_eval=False, bf16=False, concat_free=False):
    """One window of B frame-pairs: the JAX step's ``compute``.  Autograd
    records the pose head only for 'vo' and the denoiser only for 'imu'.
    ``correct_scale`` takes the VO scale from ``batch['motion']``; ``bf16``
    runs the VO networks in bfloat16 and ``concat_free`` the flow net's
    decoders without concat buffers (``tartanvo.forward``; a keyword of
    JAX's ``train_step`` and ``train_scan``, no flag).
    ``bilevel`` picks the PVGO coupling (``pvgo/run.py``); ``use_reproj``
    adds the dense reprojection factor where the VO forward runs with the
    stereo scale (train.py:106-115).  Returns (loss, aux) with ``aux``
    detached; ``aux['reproj_pixels']`` counts the factor's masked pixels
    (0 without it)."""
    # VO forward, replayed from the previous epoch in 'imu' epochs
    # (train.py:204-215)
    reproj = None
    if target == "vo" or prev_motions is None:
        with torch.set_grad_enabled(target == "vo"), record_function(
                "islam::vo_forward"):
            baseline = torch.linalg.norm(batch["extrinsic"][:, :3], dim=1)
            res = tvo.forward(
                model, batch["img0"], batch["img1"], batch["img0_norm"],
                batch["img0_r_norm"], batch["intrinsic"],
                batch["intrinsic_calib"], baseline,
                frames=batch.get("frames"), datatype=datatype,
                use_kitti_coord=use_kitti_coord, correct_scale=correct_scale,
                gt_motion=batch.get("motion"), frozen_bn_eval=frozen_bn_eval,
                bf16=bf16, concat_free=concat_free)
            # camera -> IMU frame conjugation (train.py:214-215)
            T_IL = rgb2imu_pose
            motions = lie.se3_mul(T_IL[None], lie.se3_mul(
                res["motion"], lie.se3_inv(T_IL)[None]))
        if use_reproj and not correct_scale:
            k = res["intrinsic"]
            reproj = DenseReprojectionLoss(
                res["depth"], res["flow"], k[0], k[1], k[2], k[3],
                res["mask"] & res["depth_mask"], rgb2imu_pose)
    else:
        motions = prev_motions

    with torch.set_grad_enabled(target == "imu"), record_function(
            "islam::imu"):
        imu = integrate_window(denoiser, *imu_win, init_state, gravity,
                               accel_bias, gyro_bias, subtract_bias,
                               denoise_accel=denoise_accel,
                               denoise_gyro=denoise_gyro)
        imu_poses = torch.cat([imu["pos"], imu["rot"]], dim=1)

    with record_function("islam::pvgo"):
        trans_loss, rot_loss, pgo_poses, pgo_vels, _ = run_pvgo(
            imu_poses, imu["vel"], motions, batch["links"], batch["dts"],
            imu["drot"], imu["dpos"], imu["dvel"], radius=1e4,
            loss_weight=loss_weight, reproj=reproj, target=target,
            bilevel=bilevel)

        loss = torch.sum(rot_w * rot_loss) + torch.sum(trans_w * trans_loss)
        tail_q = pgo_poses[-1, 3:]
        carry = IMUState(pos=pgo_poses[-1, :3],
                         rot=tail_q / torch.linalg.norm(tail_q),
                         vel=pgo_vels[-1])
        aux = {"motions": motions, "imu_poses": imu_poses,
               "imu_vels": imu["vel"], "pgo_poses": pgo_poses,
               "pgo_vels": pgo_vels, "trans_loss": torch.sum(trans_loss),
               "rot_loss": torch.sum(rot_loss)}
        aux = {k: v.detach() for k, v in aux.items()}
        aux["reproj_pixels"] = (torch.zeros((), dtype=torch.int64,
                                            device=pgo_poses.device)
                                if reproj is None else reproj.mask.sum())
    aux["carry"] = carry
    return loss, aux


def train_step(model, batch, imu_win, init_state, rgb2imu_pose, gravity,
               accel_bias, gyro_bias, subtract_bias, target="",
               denoiser=None, params=None, backward_events=None, **kw):
    """One window of the JAX ``train_step``.  Returns (loss, grads, aux).

    ``grads`` is {name: gradient} of ``params``: by default every pose-head
    parameter for 'vo' and every denoiser parameter for 'imu'.  It is None
    for '' and for 'imu' without a denoiser, where nothing is trainable.
    ``prev_motions`` (in ``kw``) replays the VO motions in 'imu' epochs.
    ``backward_events``, a pair of CUDA events, is recorded around the
    backward pass.  The nonfinite guard runs on the device, with no host
    sync.
    """
    if target not in ("", "vo", "imu"):
        raise ValueError(f"unknown target {target!r}")
    if params is None:
        if target == "vo":
            params = pose_params(model)
        elif target == "imu" and denoiser is not None:
            params = dict(denoiser.named_parameters())
    with torch.set_grad_enabled(bool(params)):
        loss, aux = window_loss(model, batch, imu_win, init_state,
                                rgb2imu_pose, gravity, accel_bias, gyro_bias,
                                subtract_bias, target=target,
                                denoiser=denoiser, **kw)
    grads = None
    if params:
        with record_function("islam::backward"):
            if backward_events is not None:
                backward_events[0].record()
            gs = torch.autograd.grad(loss, list(params.values()),
                                     allow_unused=True)
            if backward_events is not None:
                backward_events[1].record()
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), gs)}
    loss = loss.detach()
    with record_function("islam::guard"):
        grads, aux = _guard_nonfinite(loss, grads, aux, init_state)
    return loss, grads, aux


def _guard_nonfinite(loss, grads, aux, init_state):
    """Bad-window containment, on the device: if the loss or any gradient
    is nonfinite, the window's gradients are zeroed and the carry falls back
    to the window's init state.  ``aux['ok']`` reports it.  Returns
    (grads, aux)."""
    ok = torch.isfinite(loss)
    if grads is not None:
        for g in grads.values():
            ok = ok & torch.isfinite(g).all()
        grads = {k: torch.where(ok, g, torch.zeros_like(g))
                 for k, g in grads.items()}
    aux = dict(aux)
    aux["carry"] = IMUState(*(torch.where(ok, c, i)
                              for c, i in zip(aux["carry"], init_state)))
    aux["ok"] = ok
    return grads, aux


def add_grads(total, grads):
    """``total`` plus ``grads``, name by name, summed into ``total``'s
    tensors; either may be None."""
    if grads is None:
        return total
    if total is None:
        return grads
    for k, g in grads.items():
        total[k].add_(g)
    return total


# aux entries ``train_scan`` stacks per window
SCAN_AUX = ("motions", "imu_poses", "imu_vels", "pgo_poses", "pgo_vels",
            "trans_loss", "rot_loss", "ok", "reproj_pixels")


def train_scan(model, batches, imu_wins, init_state, rgb2imu_pose, gravity,
               accel_bias, gyro_bias, subtract_bias, target="vo",
               denoiser=None, params=None, prev_motions=None,
               backward_events=None, **kw):
    """K sequential windows of ``train_step`` with nothing read back to the
    host between them (islam_tpu/train.py:200-255): the carry goes from
    window to window and the gradients are summed on the device.

    ``batches`` and ``imu_wins`` are lists of K windows, or one window dict
    and one IMU tuple whose tensors have a leading K axis; so is
    ``prev_motions`` (K, B, 7), if given.  ``backward_events``: K pairs of
    CUDA events for ``train_step``.  ``kw`` goes to ``train_step``
    (``bf16``, ``bilevel``, ...).  Returns (losses (K,), the summed
    gradients or None, aux: ``SCAN_AUX`` stacked per window and 'carry', the
    last window's).  Only training targets: an inference epoch steps window
    by window."""
    if target not in ("vo", "imu"):
        raise ValueError(f"train_scan needs target 'vo' or 'imu', got "
                         f"{target!r}; inference epochs use train_step")
    if isinstance(batches, dict):
        K = next(iter(batches.values())).shape[0]
        batches = [{k: v[i] for k, v in batches.items()} for i in range(K)]
        imu_wins = [tuple(x[i] for x in imu_wins) for i in range(K)]
    K = len(batches)
    losses, auxs, grads = [], [], None
    for k in range(K):
        loss, g, aux = train_step(
            model, batches[k], imu_wins[k], init_state, rgb2imu_pose,
            gravity, accel_bias, gyro_bias, subtract_bias, target=target,
            denoiser=denoiser, params=params,
            backward_events=(None if backward_events is None
                             else backward_events[k]),
            prev_motions=None if prev_motions is None else prev_motions[k],
            **kw)
        grads = add_grads(grads, g)
        init_state = aux["carry"]
        losses.append(loss)
        auxs.append(aux)
    out = {k: torch.stack([a[k] for a in auxs]) for k in SCAN_AUX}
    out["carry"] = init_state
    return torch.stack(losses), grads, out


class Trainer:
    """Owns dataset iteration, the state carry, gradient accumulation, the
    optimizers, the snapshots and the checkpoints."""

    # The flow net's decoders without concat buffers, a keyword of
    # ``train_step`` and no flag (as in JAX); the measurement tools set it.
    concat_free = False

    def __init__(self, args, dataset, device="cuda", state_dict=None):
        self.args = args
        self.dataset = dataset
        self.device = torch.device(device)
        h, w = dataset[0]["img0"].shape[:2]
        self.model = tvo.init_model(h, w, seed=0, device=self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        # the full VONet, then the pose head over it (train.py:314-319)
        for name in (args.vo_model_name, args.pose_model_name):
            if name:
                ckpt.import_torch_weights(self.model,
                                          ckpt.load_torch_state_dict(name))

        # The pose head's optimizer.  --fix-model-parts leaves the named
        # sub-trees out of it: they are never updated (the reference's
        # requires_grad=False, VONet.py:20-26 / VOFlowNet.py:95-102).
        frozen = [POSE_FIX[p] for p in args.fix_model_parts if p in POSE_FIX]
        self.vo_params = optim.trainable(pose_params(self.model).items(),
                                         frozen)
        self.vo_opt = optim.OPTIMIZERS[args.vo_optimizer](args.lr)
        self.vo_opt_state = self.vo_opt.init(self.vo_params)

        self.denoiser = None
        if args.imu_denoise_model_name:
            denoiser = IMUDenoiser().to(self.device)
            denoiser.load_state_dict(ckpt.import_denoiser(
                ckpt.load_torch_state_dict(args.imu_denoise_model_name)))
            self._add_denoiser(denoiser)

        # --frozen-bn-eval only when the stereo net is frozen: a trained
        # stereo net would stop updating its statistics (train.py:335-336)
        self.frozen_bn_eval = (args.frozen_bn_eval
                               and "stereo" in args.fix_model_parts)

        self.imu_module = IMUModule(
            dataset.accels, dataset.gyros, dataset.imu_dts,
            dataset.accel_bias, dataset.gyro_bias, gravity=dataset.gravity,
            rgb2imu_sync=dataset.rgb2imu_sync, denoise_params=self.denoiser,
            denoise_accel=True, denoise_gyro=(dataset.datatype != "kitti"),
            batch_frames=args.batch_size, device=self.device)
        self.rgb2imu_pose = torch.tensor(np.asarray(dataset.rgb2imu_pose),
                                         dtype=torch.float32,
                                         device=self.device)
        self.train_target = [""] + ["vo", "imu"] * 100
        self.prev_vo_motions = None
        # The last epoch's summed gradients (None if it trained nothing).
        self.last_grads = None
        # Per epoch: the wall time of each window (device synced), the main
        # thread's wait for its inputs (all of their preparation when
        # nothing was prefetched), and its backward pass (CUDA events; card
        # only).  ``prep_split_seconds``: each window's preparation, on
        # whichever thread made it, as {'decode': image decoding,
        # 'transforms': the rest of the window's arrays, 'copy':
        # pinning and the copy to the device, IMU inputs included,
        # 'images': the images decoded, 'cpu': that thread's CPU seconds
        # over decode + transforms}.
        self.window_seconds = {}
        self.prep_seconds = {}
        self.prep_split_seconds = {}
        self.backward_seconds = {}
        # Per epoch and window: the reprojection factor's masked pixels
        # (0 without the factor).
        self.reproj_pixels = {}
        # Per epoch: each window's upper-level loss.
        self.window_losses = {}
        # Per epoch under --scan-chunk: the wall time of each chunk (device
        # synced); each of its windows gets chunk / K in window_seconds.
        self.chunk_seconds = {}
        self._copy_stream = None
        self._profiled = False

    def _state(self, init: Dict) -> IMUState:
        return IMUState(*(torch.tensor(np.asarray(init[k]), dtype=torch.float32,
                                       device=self.device)
                          for k in ("pos", "rot", "vel")))

    def prepare(self, bi):
        """Window ``bi``'s device inputs: (batch, imu_win, copy event or
        None, preparation record).  On the card the copies go through
        pinned memory on a stream of their own, so that a worker thread's
        copy does not queue behind the window the main thread is running;
        the consumer waits on the event (``_use``).  The window's arrays
        are ``dataset.window``'s (each distinct frame decoded once where
        the links are consecutive).  The record's images and decode seconds
        are this call's own (its tally), so a decode on another thread
        meanwhile does not land in it.  The call is the ``islam::prepare``
        range of a profiler that follows its thread."""
        with record_function("islam::prepare"):
            B = self.args.batch_size
            current_idx = bi * B
            tally = {"images": 0, "decode": 0.0}
            t0 = time.perf_counter()
            c0 = time.thread_time()
            sample = self.dataset.window(current_idx, B, tally)
            c1 = time.thread_time()
            t1 = time.perf_counter()
            decode = tally["decode"]
            event = None
            if self.device.type == "cuda":
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._copy_stream):
                    batch = device_batch(sample, current_idx, self.device,
                                         pin=True)
                    imu_win = self.imu_module.window_inputs(current_idx,
                                                            current_idx + B)
                    event = torch.cuda.Event()
                    event.record(self._copy_stream)
                event.synchronize()
            else:
                batch = device_batch(sample, current_idx, self.device)
                imu_win = self.imu_module.window_inputs(current_idx,
                                                        current_idx + B)
            split = {"decode": decode, "transforms": t1 - t0 - decode,
                     "copy": time.perf_counter() - t1,
                     "images": tally["images"], "cpu": c1 - c0}
            return batch, imu_win, event, split

    def _use(self, batch, imu_win, event):
        """Order the current stream after the copy ``event`` and tell the
        allocator that the copied tensors are used on it."""
        if event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in (*batch.values(), *imu_win):
            t.record_stream(stream)

    def run_epoch(self, epoch, snapshot_dir=None, snapshot_interval=None):
        args = self.args
        target = self.train_target[epoch]
        params = None
        if target == "vo":
            params = self.vo_params
        elif target == "imu" and self.denoiser is not None:
            params = self.imu_params
        B = args.batch_size
        n_batches = len(self.dataset) // B
        traj = _TrajLogs(self.dataset.imu_init)
        init_state = self._state(self.dataset.imu_init)
        pending = []
        epoch_motions = []
        grad_accum = None
        bad_windows = 0
        subtract_bias = torch.tensor(self.imu_module.optm_bias,
                                     device=self.device)
        on_card = self.device.type == "cuda"
        windows = self.window_seconds[epoch] = []
        preps = self.prep_seconds[epoch] = []
        splits = self.prep_split_seconds[epoch] = []
        backwards = self.backward_seconds[epoch] = []
        chunks = self.chunk_seconds[epoch] = []
        pixels, losses = [], []
        # One window (or chunk) ahead on a worker thread
        # (islam_tpu/train.py:432-451): only the init state depends on the
        # previous window, and it stays on the device.  Off on single-core
        # hosts, where the thread only contends with the main loop.
        use_prefetch = args.worker_num >= 1 and (os.cpu_count() or 1) > 1
        prefetcher = Prefetcher(self.prepare) if use_prefetch else None
        datatype = self.dataset.datatype
        consts = (self.rgb2imu_pose, self.imu_module.gravity,
                  self.imu_module.accel_bias, self.imu_module.gyro_bias,
                  subtract_bias)
        step_kw = dict(
            target=target, denoiser=self.denoiser, params=params,
            datatype=datatype, use_kitti_coord=(datatype != "tartanair"),
            correct_scale=args.use_gt_scale, denoise_accel=True,
            denoise_gyro=(datatype != "kitti"),
            loss_weight=tuple(float(w) for w in args.loss_weight),
            rot_w=args.rot_w, trans_w=args.trans_w, bilevel=args.bilevel,
            use_reproj=args.reproj_points > 0,
            frozen_bn_eval=self.frozen_bn_eval, bf16=args.bf16,
            concat_free=self.concat_free)

        def flush():
            nonlocal bad_windows
            with record_function("islam::flush"):
                for a in pending:
                    m, pg, pv, ip = (a[k].cpu().numpy() for k in (
                        "motions", "pgo_poses", "pgo_vels", "imu_poses"))
                    bad_windows += int(not bool(a["ok"]))
                    traj.extend(m, pg, pv, ip)
                pending.clear()

        def snapshot():
            with record_function("islam::snapshot"):
                traj.save(snapshot_dir, epoch)

        def replayed(bi, k):
            """The VO motions of windows bi .. bi+k-1 that 'imu' and eval
            epochs replay, or None."""
            if target == "vo" or self.prev_vo_motions is None:
                return None
            return self.prev_vo_motions[bi * B:(bi + k) * B]

        def timing_events():
            if not (on_card and params):
                return None
            return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        # ---- K windows at a time through train_scan
        # (islam_tpu/train.py:453-537): 'vo' and 'imu' epochs only, full
        # chunks only; the n_batches % K windows of the tail run below ----
        K = args.scan_chunk
        n_chunks = n_batches // K if K > 1 and target in ("vo", "imu") else 0

        def prepare_chunk(ci):
            return [self.prepare(ci * K + k) for k in range(K)]

        chunk_pf = (Prefetcher(prepare_chunk) if use_prefetch and n_chunks
                    else None)
        last_snap = last_print = 0
        for ci in range(n_chunks):
            t0 = time.perf_counter()
            with record_function("islam::prefetch_wait"):
                if chunk_pf is not None and chunk_pf.pending(ci):
                    items = chunk_pf.take(ci)
                else:
                    items = prepare_chunk(ci)
            if chunk_pf is not None and ci + 1 < n_chunks:
                chunk_pf.start(ci + 1)
            for batch, imu_win, event, split in items:
                self._use(batch, imu_win, event)
                splits.append(split)
            preps.extend([(time.perf_counter() - t0) / K] * K)
            bi = ci * K
            prev = replayed(bi, K)
            events = [timing_events() for _ in range(K)]
            with record_function("islam::step"):
                chunk_losses, grads, aux = train_scan(
                    self.model, [it[0] for it in items],
                    [it[1] for it in items], init_state, *consts,
                    prev_motions=(None if prev is None
                                  else prev.reshape(K, B, -1)),
                    backward_events=None if events[0] is None else events,
                    **step_kw)
            grad_accum = add_grads(grad_accum, grads)
            init_state = aux["carry"]
            for k in range(K):
                pending.append({n: aux[n][k] for n in SCAN_AUX})
                epoch_motions.append(aux["motions"][k])
            pixels.extend(aux["reproj_pixels"].unbind(0))
            losses.extend(chunk_losses.unbind(0))
            with record_function("islam::sync"):
                if on_card:
                    torch.cuda.synchronize(self.device)
                chunks.append(time.perf_counter() - t0)
                windows.extend([chunks[-1] / K] * K)
                if events[0] is not None:
                    backwards.extend(a.elapsed_time(b) / 1e3
                                     for a, b in events)
            bi += K
            # bi moves by K: fire on every interval boundary crossed
            if snapshot_dir and (bi <= 10 or (
                    snapshot_interval
                    and bi // snapshot_interval > last_snap)):
                last_snap = bi // max(snapshot_interval or 1, 1)
                flush()
                snapshot()
            if args.print_interval and bi // args.print_interval > last_print:
                last_print = bi // args.print_interval
                print(f"[window {bi}/{n_batches}] target={target} "
                      f"loss={float(chunk_losses.sum()):.6f} "
                      f"chunk={chunks[-1]:.3f}s")

        # ---- window by window: every window, or the tail of a scanned
        # epoch ----
        for bi in range(n_chunks * K, n_batches):
            t0 = time.perf_counter()
            with record_function("islam::prefetch_wait"):
                if prefetcher is not None and prefetcher.pending(bi):
                    batch, imu_win, event, split = prefetcher.take(bi)
                else:
                    batch, imu_win, event, split = self.prepare(bi)
            if prefetcher is not None and bi + 1 < n_batches:
                prefetcher.start(bi + 1)
            self._use(batch, imu_win, event)
            preps.append(time.perf_counter() - t0)
            splits.append(split)
            events = timing_events()
            # --profile-dir: a trace of the second window, once per Trainer
            # (islam_tpu/train.py:555-582)
            profiling = bool(args.profile_dir) and bi == 1 and (
                not self._profiled)
            if profiling:
                self._profiled = True
            with (self._profile(epoch, bi) if profiling
                  else contextlib.nullcontext()), record_function(
                      "islam::step"):
                loss, grads, aux = train_step(
                    self.model, batch, imu_win, init_state, *consts,
                    backward_events=events, prev_motions=replayed(bi, 1),
                    **step_kw)
            grad_accum = add_grads(grad_accum, grads)
            pixels.append(aux["reproj_pixels"])
            losses.append(loss)
            # ---- state carry stays on the device (train.py:296-299) ----
            init_state = aux["carry"]
            pending.append(aux)
            epoch_motions.append(aux["motions"])
            with record_function("islam::sync"):
                if on_card:
                    torch.cuda.synchronize(self.device)
                windows.append(time.perf_counter() - t0)
                if events is not None:
                    backwards.append(events[0].elapsed_time(events[1]) / 1e3)

            if snapshot_dir and (bi < 10 or (
                    snapshot_interval and (bi + 1) % snapshot_interval == 0)):
                flush()
                snapshot()
            if args.print_interval and (bi + 1) % args.print_interval == 0:
                print(f"[step {bi + 1}/{n_batches}] target={target} "
                      f"loss={float(loss):.6f} step={windows[-1]:.3f}s")

        flush()
        if bad_windows:
            print(f"WARNING: {bad_windows} window(s) produced a nonfinite "
                  "loss or gradient; their gradients were zeroed and their "
                  "state carries reset (aux['ok'])")
        # ---- ONE optimizer update per epoch (train.py:172-179) ----
        if grad_accum is not None:
            with record_function("islam::optimizer"):
                if target == "vo":
                    updates, self.vo_opt_state = self.vo_opt.update(
                        grad_accum, self.vo_opt_state)
                    optim.apply_updates(self.vo_params, updates)
                else:
                    updates, self.imu_opt_state = self.imu_opt.update(
                        grad_accum, self.imu_opt_state)
                    optim.apply_updates(self.imu_params, updates)
        self.last_grads = grad_accum
        self.reproj_pixels[epoch] = [int(p) for p in pixels]
        self.window_losses[epoch] = [float(x) for x in losses]
        self.prev_vo_motions = torch.cat(epoch_motions)
        if snapshot_dir:
            snapshot()
        return traj

    @contextlib.contextmanager
    def _profile(self, epoch, bi):
        """A ``torch.profiler`` trace (CPU and, on the card, CUDA activity)
        of what runs inside, written as a Chrome trace into
        ``--profile-dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir,
                            f"epoch{epoch}_window{bi}_trace.json")
        prof.export_chrome_trace(path)
        print(f"profile trace of epoch {epoch} window {bi}: {path}")

    def _add_denoiser(self, denoiser):
        """Train ``denoiser`` in 'imu' epochs, with Adam at --imu-lr
        (default 3e-5, the reference's hard-coded denoiser lr,
        train.py:142)."""
        self.denoiser = denoiser
        self.imu_params = dict(denoiser.named_parameters())
        self.imu_opt = optim.adam(self.args.imu_lr)
        self.imu_opt_state = self.imu_opt.init(self.imu_params)

    def checkpoint_state(self) -> Dict:
        """What an epoch's save holds: the VONet and its optimizer state,
        and the denoiser and its optimizer state where there is one (beyond
        the reference, whose state_dict-only saves lose the optimizer
        moments on resume, train.py:181-189)."""
        state = {"model": self.model.state_dict(),
                 "vo_opt_state": optim.state_dict(self.vo_opt_state)}
        if self.denoiser is not None:
            state["denoiser"] = self.denoiser.state_dict()
            state["imu_opt_state"] = optim.state_dict(self.imu_opt_state)
        return state

    def save_models(self, directory, epoch):
        return ckpt.save_checkpoint(directory, epoch, self.checkpoint_state())

    def resume(self, directory, start_epoch):
        """Restore the newest save k < ``start_epoch`` (the reference's
        resume scan, train.py:102-107,124-129); returns k, or None if there
        is none.  As in the JAX package, the VO motions of the previous
        epoch are not saved, so an 'imu' epoch right after a resume runs
        the VO forward instead of replaying.  A save without optimizer
        states (a JAX params-only save, ``utils/jax_state.py``) keeps the
        trainer's fresh ones and says so (islam_tpu/train.py:657-702)."""
        step = ckpt.latest_checkpoint_step(directory, start_epoch)
        if step is None:
            return None
        state = ckpt.restore_checkpoint(directory, step, self.device)
        report_missing(directory, step, ["model", "vo_opt_state"] + (
            [] if self.denoiser is None else ["denoiser", "imu_opt_state"]),
            state)
        if "denoiser" in state and self.denoiser is None:
            # A save with a denoiser, into a trainer built without one: build
            # it and its Adam(--imu-lr) and restore both, as the JAX package
            # does (islam_tpu/train.py:677-698).
            self._add_denoiser(IMUDenoiser().to(self.device))
        self.model.load_state_dict(state["model"])
        if "vo_opt_state" in state:
            self.vo_opt_state = optim.load_state_dict(state["vo_opt_state"],
                                                      self.device)
        if "denoiser" in state:
            self.denoiser.load_state_dict(state["denoiser"])
        if "imu_opt_state" in state:
            self.imu_opt_state = optim.load_state_dict(
                state["imu_opt_state"], self.device)
        print(f"Resumed from {directory}/{step}")
        return step


def report_missing(directory, step, keys, state):
    """Print which of ``keys`` the save ``directory/step`` lacks, as the
    JAX package's resume does (islam_tpu/train.py:670-676)."""
    dropped = sorted(set(keys) - set(state))
    if dropped:
        print(f"Checkpoint {directory}/{step} has no {dropped}; "
              "restoring without them (fresh optimizer state)")


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
    """The entry point: ``--eval-only`` runs epoch 0; otherwise epochs
    ``--start-epoch`` .. ``--train-epoch`` train, each saved under
    ``--save-model-dir`` when given, after a resume from there when
    ``--start-epoch`` > 1.  Returns the Trainer."""
    from islam_tpu_torch.arguments import get_args
    from islam_tpu_torch.data.dataset import TrajFolderDataset
    from islam_tpu_torch.data.synthetic import SyntheticTrajDataset

    args = get_args(argv)
    print(args)
    # The preset runs in float32: cuDNN's default TF32 convolutions would
    # keep only ~3 decimal digits.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    transform = make_transform(args.image_height, args.image_width)
    if args.data_type == "synthetic":
        dataset = SyntheticTrajDataset(
            num_frames=args.synthetic_frames, height=args.image_height,
            width=args.image_width, transform=transform)
    else:
        if not os.path.isdir(args.data_root):
            raise FileNotFoundError(f"--data-root {args.data_root!r}: no "
                                    f"such {args.data_type} sequence folder")
        dataset = TrajFolderDataset(
            datadir=args.data_root, datatype=args.data_type,
            transform=transform, start_frame=args.start_frame,
            end_frame=args.end_frame)
    trainer = Trainer(args, dataset, device=args.device)
    if args.start_epoch > 1 and args.save_model_dir:
        trainer.resume(args.save_model_dir, args.start_epoch)

    trainroot = args.result_dir or "."
    if args.result_dir:
        os.makedirs(trainroot, exist_ok=True)
        with open(trainroot + "/args.txt", "w") as f:
            f.write(str(args))
        np.savetxt(trainroot + "/gt_pose.txt", dataset.poses)
        np.savetxt(trainroot + "/timestamp.txt", dataset.rgb_ts, fmt="%.3f")

    epochs = ([0] if args.eval_only
              else range(args.start_epoch, args.train_epoch + 1))
    for epoch in epochs:
        t0 = time.time()
        trainer.run_epoch(epoch, snapshot_dir=args.result_dir or None,
                          snapshot_interval=args.snapshot_interval)
        if args.save_model_dir and not args.eval_only:
            trainer.save_models(args.save_model_dir, epoch)
        print(f"epoch {epoch} target={trainer.train_target[epoch]!r} "
              f"time={time.time() - t0:.1f}s "
              f"(snapshots under {trainroot}/{epoch})")
    return trainer


if __name__ == "__main__":
    main()
