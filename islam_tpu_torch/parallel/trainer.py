"""Multi-sequence imperative trainer over ``torch.distributed`` ranks.

Counterpart of ``islam_tpu/parallel/trainer.py``: N independent
trajectories train one shared pose head (and IMU denoiser) at once.  Each
rank holds its own block of sequences (``host_local_batch_slice``) and runs
them one after another on its device; each sequence carries its own PVGO
state and trains against its own calibration (T_BS, gravity, biases: KITTI
drives of different dates differ).  Parameters are replicated, bitwise: every
rank applies the same Adam step to the same all-reduced gradients.

As in the JAX package: the alternating schedule [''] + ['vo', 'imu'] * 100
with the VO motions replayed in 'imu' epochs, a per-epoch reset to each
dataset's init state, ``scan_chunk`` with the tail on the per-window step,
per-sequence snapshots under ``{dir}/seq{i}/{epoch}/`` (``i`` the global
index), one optimizer update per epoch, and save and resume.

As in JAX, each window (or scanned chunk) goes through
``multi_sequence_train_step`` (``multi_sequence_train_scan``): the gradients
are averaged over the N sequences once a window, one all-reduce a window,
and the means are summed over the epoch.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from islam_tpu_torch import optim, testing
from islam_tpu_torch.imu.denoiser import IMUDenoiser
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.models import tartanvo as tvo
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.parallel.mesh import (collective_device, make_mesh,
                                           min_max_over_ranks,
                                           multi_sequence_train_scan,
                                           multi_sequence_train_step,
                                           replicate)
from islam_tpu_torch.train import (SCAN_AUX, _TrajLogs, add_grads,
                                   device_batch, pose_params, report_missing)
from islam_tpu_torch.utils import checkpoints as ckpt

STATE_KEYS = ("pos", "rot", "vel")


class MultiSequenceTrainer:
    """Trains the shared VO pose head on N sequences in parallel.

    ``datasets``: this rank's sequences (TrajFolderDataset-likes), the
    block ``host_local_batch_slice(N)`` of the N; every rank holds as many.
    ``state_dict`` (a VONet's) and ``denoiser_state_dict`` are the starting
    weights (default: ``tvo.init_model`` seed 0, no denoiser); every rank
    must pass the same.  ``device`` defaults to the mesh's, ``cuda:{local
    rank}``.
    """

    def __init__(self, datasets: List[Any], batch_size: int = 8,
                 lr: float = 3e-6, imu_lr: float = 3e-5,
                 loss_weight=(1., 0.1, 10., 0.1),
                 rot_w: float = 1.0, trans_w: float = 0.1,
                 correct_scale: bool = False, bf16: bool = False,
                 mesh=None, state_dict=None, denoiser_state_dict=None,
                 device=None):
        self.mesh = mesh if mesh is not None else make_mesh(
            device="cuda" if device is None else device)
        self.device = (self.mesh.device if device is None
                       else torch.device(device))
        self.datasets = datasets
        self.B = batch_size
        datatype = datasets[0].datatype
        if any(ds.datatype != datatype for ds in datasets):
            raise ValueError("datatype is a static config; mixed-datatype "
                             "sequence sets need one trainer per datatype")
        h, w = datasets[0][0]["img0"].shape[:2]

        self.imus = [testing.make_imu_module(
            ds, batch_size, denoiser_state_dict, self.device)
            for ds in datasets]
        # What every rank must share, in one collective: the sequence count
        # a rank holds, the datatype and the image size are static; the
        # padded IMU window S is the most over ALL sequences (padding feeds
        # the denoiser) and the epoch's windows the fewest.
        agreed = min_max_over_ranks({
            "n_local": len(datasets),
            "datatype": zlib.crc32(datatype.encode()),
            "h": h, "w": w, "S": max(m.S for m in self.imus),
            "frames": min(len(ds) for ds in datasets)})
        for name in ("n_local", "datatype", "h", "w"):
            lo, hi = agreed[name]
            if lo != hi:
                raise ValueError(f"ranks disagree on {name}: {lo} to {hi}")
        for m in self.imus:
            m.S = agreed["S"][1]
        self.n_frames = agreed["frames"][0]
        self.first = self.mesh.rank * len(datasets)  # global index of seq 0

        if state_dict is None:
            model = tvo.init_model(h, w, seed=0, device=self.device)
        else:
            model = VONet(h, w)
            model.load_state_dict(state_dict)
            model.to(self.device)
        model.load_state_dict(replicate(self.mesh, model.state_dict()))
        self.model = model
        self.vo_params = pose_params(model)
        self.opt = optim.adam(lr)
        self.opt_state = self.opt.init(self.vo_params)
        self._imu_lr = imu_lr
        self.denoiser = None
        if denoiser_state_dict is not None:
            self._add_denoiser(denoiser_state_dict)

        self._static_kwargs = dict(
            datatype=datatype, correct_scale=correct_scale,
            use_kitti_coord=(datatype != "tartanair"),
            denoise_accel=True, denoise_gyro=(datatype != "kitti"),
            loss_weight=tuple(float(x) for x in loss_weight),
            rot_w=rot_w, trans_w=trans_w, bf16=bf16)
        # alternating bi-level schedule, indexable by epoch (train.py:151)
        self.train_target = [""] + ["vo", "imu"] * 100
        self.prev_vo_motions = None  # (n_local, windows*B, 7) after an epoch

        # Per-sequence calibration constants, (n_local, ...) on the device.
        def rows(vals, dtype=torch.float32):
            return torch.stack([torch.as_tensor(np.asarray(v), dtype=dtype)
                                for v in vals]).to(self.device)
        self._consts = (
            rows([ds.rgb2imu_pose for ds in datasets]),
            torch.stack([m.gravity for m in self.imus]),
            torch.stack([m.accel_bias for m in self.imus]),
            torch.stack([m.gyro_bias for m in self.imus]),
            rows([m.optm_bias for m in self.imus], torch.bool))
        self._init_states = [
            {k: np.asarray(ds.imu_init[k], np.float32) for k in STATE_KEYS}
            for ds in datasets]
        # Per epoch: window wall times (all local sequences, device synced),
        # backward times (CUDA events; card only), each window's (or
        # chunk's) collective, ms and bytes, and the summed gradients.
        self.window_seconds = {}
        self.backward_seconds = {}
        self.collective = {}
        self.last_grads = None

    def _add_denoiser(self, denoiser_state_dict):
        """Train a denoiser in 'imu' epochs with Adam at ``imu_lr`` (the
        reference's hard-coded denoiser lr, train.py:142)."""
        dn = IMUDenoiser().to(self.device)
        dn.load_state_dict(denoiser_state_dict)
        dn.load_state_dict(replicate(self.mesh, dn.state_dict()))
        self.denoiser = dn
        self.imu_params = dict(dn.named_parameters())
        self.imu_opt = optim.adam(self._imu_lr)
        self.imu_opt_state = self.imu_opt.init(self.imu_params)

    def _window_inputs(self, start):
        """Window [start, start+B) of every local sequence: lists."""
        batches, wins = [], []
        for ds, imu in zip(self.datasets, self.imus):
            sample = ds.window(start, self.B)
            batches.append(device_batch(sample, start, self.device))
            wins.append(imu.window_inputs(start, start + self.B))
        return batches, wins

    def run_epoch(self, scan_chunk: int = 0, epoch: int = 1,
                  snapshot_dir: Optional[str] = None,
                  snapshot_interval: Optional[int] = None):
        """One epoch over all sequences; returns each window's loss, the
        mean over all N sequences.

        ``epoch`` indexes the schedule: 0 infers, odd epochs train the pose
        head, even epochs the denoiser, with the VO forward replaced by the
        previous epoch's motions of each sequence.  ``scan_chunk`` > 1 runs
        a training epoch's windows that many at a time through
        ``train_scan``; the remainder, and inference epochs, run window by
        window.  ``snapshot_dir``: each sequence's trajectory under
        ``{snapshot_dir}/seq{i}/{epoch}/`` in the reference's layout
        (train.py:51-61), written by the rank that holds sequence ``i``.
        """
        target = self.train_target[epoch]
        if target == "imu" and self.denoiser is None:
            raise ValueError(
                f"epoch {epoch} targets the IMU denoiser but no denoiser was "
                "given; pass denoiser_state_dict= at construction")
        B, n_local = self.B, len(self.datasets)
        n_batches = self.n_frames // B
        on_card = self.device.type == "cuda"
        params = {"vo": self.vo_params,
                  "imu": getattr(self, "imu_params", None)}.get(target)
        kw = dict(self._static_kwargs, target=target, params=params)
        step = multi_sequence_train_step(self.mesh, **kw)
        prev = None
        if target not in ("vo", "") and self.prev_vo_motions is not None:
            prev = self.prev_vo_motions
        # per-epoch reset to the dataset init states (train.py:195-196)
        inits = [testing.init_state(ds, self.device)
                 for ds in self.datasets]
        trajs = [_TrajLogs(dict(ds.imu_init)) for ds in self.datasets]
        pending, epoch_motions = [], []   # aux per window: (n_local, ...)
        window_losses, grads = [], None
        windows = self.window_seconds[epoch] = []
        backwards = self.backward_seconds[epoch] = []
        collectives = self.collective[epoch] = []

        def flush():
            for aux in pending:
                m, pg, pv, ip = (aux[k].cpu().numpy() for k in (
                    "motions", "pgo_poses", "pgo_vels", "imu_poses"))
                for s in range(n_local):
                    trajs[s].extend(m[s], pg[s], pv[s], ip[s])
            pending.clear()

        def save_snapshots():
            if not snapshot_dir:
                return
            flush()
            for s, t in enumerate(trajs):
                t.save(os.path.join(snapshot_dir, f"seq{self.first + s}"),
                       epoch)

        def events(k):
            """[sequence][window] pairs of CUDA events around each backward
            of a chunk of ``k`` windows, or None."""
            if not (on_card and params):
                return None
            return [[[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                     for _ in range(k)] for _ in range(n_local)]

        def close_window(t0, ev, k=1):
            if on_card:
                torch.cuda.synchronize(self.device)
            windows.extend([(time.perf_counter() - t0) / k] * k)
            if ev is not None:  # per window: all local sequences' backwards
                backwards.extend(sum(ev[s][i][0].elapsed_time(ev[s][i][1])
                                     for s in range(n_local)) / 1e3
                                 for i in range(k))

        bi = last_snap = 0
        # Training epochs only: the scan accumulates gradients, so an
        # inference epoch (with or without a denoiser) steps window by
        # window below, as the JAX trainer's guard does.
        if scan_chunk > 1 and target in ("vo", "imu"):
            K = scan_chunk
            scan = multi_sequence_train_scan(self.mesh, **kw)
            while bi + K <= n_batches:
                t0 = time.perf_counter()
                per_win = [self._window_inputs((bi + k) * B)
                           for k in range(K)]
                ev = events(K)
                collectives.append({})
                losses, g, aux = scan(
                    self.model, self.denoiser,
                    [[per_win[k][0][s] for k in range(K)]
                     for s in range(n_local)],
                    [[per_win[k][1][s] for k in range(K)]
                     for s in range(n_local)],
                    inits, *self._consts,
                    None if prev is None else prev[
                        :, bi * B:(bi + K) * B].reshape(n_local, K, B, -1),
                    record=collectives[-1], backward_events=ev)
                grads = add_grads(grads, g)
                inits = [IMUState(*(c[s] for c in aux["carry"]))
                         for s in range(n_local)]
                window_losses.extend(losses.mean(0).unbind(0))
                for k in range(K):
                    step_aux = {n: aux[n][:, k] for n in SCAN_AUX}
                    pending.append(step_aux)
                    epoch_motions.append(step_aux["motions"])
                close_window(t0, ev, K)
                bi += K
                if snapshot_interval and bi // snapshot_interval > last_snap:
                    last_snap = bi // snapshot_interval
                    save_snapshots()

        # Window by window: everything when not scanned, the tail
        # (n_batches % scan_chunk windows) when scanned.
        for bi in range(bi, n_batches):
            t0 = time.perf_counter()
            batches, wins = self._window_inputs(bi * B)
            ev = events(1)
            collectives.append({})
            loss, g, aux = step(
                self.model, self.denoiser, batches, wins, inits,
                *self._consts,
                None if prev is None else prev[:, bi * B:(bi + 1) * B],
                record=collectives[-1],
                backward_events=None if ev is None else [e[0] for e in ev])
            grads = add_grads(grads, g)
            inits = [IMUState(*(c[s] for c in aux["carry"]))
                     for s in range(n_local)]
            window_losses.append(loss)
            pending.append(aux)
            epoch_motions.append(aux["motions"])
            close_window(t0, ev)
            if snapshot_interval and (bi + 1) % snapshot_interval == 0:
                save_snapshots()

        losses = [float(x) for x in window_losses]
        self._init_states = [
            {k: v.cpu().numpy() for k, v in zip(STATE_KEYS, st)}
            for st in inits]

        # ONE optimizer update per epoch on its target (train.py:172-179)
        if grads is not None and target == "vo":
            updates, self.opt_state = self.opt.update(grads, self.opt_state)
            optim.apply_updates(self.vo_params, updates)
        elif grads is not None and target == "imu":
            updates, self.imu_opt_state = self.imu_opt.update(
                grads, self.imu_opt_state)
            optim.apply_updates(self.imu_params, updates)
        self.last_grads = grads

        save_snapshots()
        flush()
        # this epoch's motions, for the next 'imu' epoch's replay
        # (train.py:204-215): (n_local, windows*B, 7)
        if epoch_motions:
            self.prev_vo_motions = torch.cat(epoch_motions, dim=1)
        return losses

    # ---- checkpointing (parity with Trainer.save_models/resume) ----

    def _gathered_states(self):
        """Every sequence's epoch-end carry, in global order, on every rank
        (one all-gather)."""
        local = torch.stack([torch.cat([torch.as_tensor(st[k])
                                        for k in STATE_KEYS])
                             for st in self._init_states]).float()
        local = local.to(collective_device())
        parts = [torch.empty_like(local) for _ in range(self.mesh.size)]
        dist.all_gather(parts, local)
        rows = torch.cat(parts).cpu()
        return [{"pos": r[:3].clone(), "rot": r[3:7].clone(),
                 "vel": r[7:].clone()} for r in rows]

    def checkpoint_state(self):
        state = {"model": self.model.state_dict(),
                 "vo_opt_state": optim.state_dict(self.opt_state),
                 "seq_states": self._gathered_states()}
        if self.denoiser is not None:
            state["denoiser"] = self.denoiser.state_dict()
            state["imu_opt_state"] = optim.state_dict(self.imu_opt_state)
        return state

    def save_models(self, directory, epoch):
        """Every rank calls it (the carries are gathered); rank 0 writes
        ``{directory}/{epoch}/checkpoint.pt``; all return once it is
        written."""
        state = self.checkpoint_state()
        path = None
        if self.mesh.rank == 0:
            path = ckpt.save_checkpoint(directory, epoch, state)
        dist.barrier()
        return path

    def resume(self, directory, start_epoch):
        """Restore the newest save before ``start_epoch`` on every rank:
        the replicated parameters, the optimizer states, and this rank's
        sequences' carries (kept for inspection: every epoch restarts each
        trajectory from its dataset's init state, train.py:195-196).  A save
        with a denoiser, into a trainer built without one, builds it and its
        Adam(``imu_lr``).  A save without optimizer states or carries (a
        JAX params-only save, ``utils/jax_state.py``) keeps the trainer's
        and says so.  Returns the epoch restored, or None."""
        step = ckpt.latest_checkpoint_step(directory, start_epoch)
        if step is None:
            return None
        state = ckpt.restore_checkpoint(directory, step, self.device)
        report_missing(directory, step, ["model", "vo_opt_state",
                                         "seq_states"] + (
            [] if self.denoiser is None else ["denoiser", "imu_opt_state"]),
            state)
        self.model.load_state_dict(state["model"])
        if "vo_opt_state" in state:
            self.opt_state = optim.load_state_dict(state["vo_opt_state"],
                                                   self.device)
        if "denoiser" in state:
            if self.denoiser is None:
                self._add_denoiser(state["denoiser"])
            else:
                self.denoiser.load_state_dict(state["denoiser"])
        if "imu_opt_state" in state:
            self.imu_opt_state = optim.load_state_dict(
                state["imu_opt_state"], self.device)
        if "seq_states" in state:
            own = state["seq_states"][self.first:
                                      self.first + len(self.datasets)]
            self._init_states = [{k: np.asarray(st[k].cpu(), np.float32)
                                  for k in STATE_KEYS} for st in own]
        return step
