"""Multi-sequence scale-out over ``torch.distributed`` ranks.

Counterpart of ``islam_tpu/parallel/mesh.py``.  The parallel axis is
independent sequences: each trajectory carries its own window-to-window
state, so time cannot be split, but distinct sequences can.  A "mesh" here
is a process group with one rank per device:

    mesh = make_mesh()                     # the sequence axis over the ranks
    step = multi_sequence_train_step(mesh, target="vo", ...)

Rank r owns the contiguous block ``host_local_batch_slice(N)`` of the N
sequences and runs that block's sequences one after another on its device
(what JAX's step does for a sharded axis with more rows than devices: a
``vmap`` over the local rows).  The sequences are never concatenated into
one forward: the VO nets run train-mode BatchNorm on batch statistics, one
set per sequence.  Parameters are replicated; the sequence-mean loss and
gradients are the step's only collective, once a window (or a scanned
chunk) as in JAX: one ``all_reduce(SUM)`` of one flat float32 buffer (its
names in one fixed order) divided by the global N.

Backends: NCCL for ``cuda`` (one rank per GPU), gloo for ``cpu``; gloo also
reduces CUDA tensors, which runs two ranks on one GPU, where NCCL refuses.
There is no fallback: a failed ``init_process_group`` or collective raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.train import add_grads, train_scan, train_step

# seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = 1800.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The sequence axis over the ranks of the default process group; this
    rank's sequences run on ``device``."""
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size()

    @property
    def rank(self) -> int:
        return dist.get_rank()


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_device(device="cuda") -> torch.device:
    """This rank's device: ``cpu``, an indexed ``cuda:i`` as given, or for
    a bare ``cuda`` the GPU of the local rank (``LOCAL_RANK``, else the
    rank) modulo the GPUs this host has.  Raises without a GPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no GPU")
    if device.index is not None:
        return device
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the process group: one process per device.

    ``coordinator_address`` 'host:port' is rank 0's TCP store, with
    ``num_processes`` ranks (default 1) of which this is ``process_id``
    (default 0); without it, torch's ``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (as ``torchrun`` sets
    them).  ``backend`` defaults to NCCL for ``cuda`` and gloo for ``cpu``;
    ``timeout`` bounds every collective (seconds).  A no-op if a group
    already exists.
    """
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no GPU")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if coordinator_address is None:
        init_method = "env://"
        if num_processes is not None:
            kw = {"world_size": num_processes, "rank": process_id or 0}
    else:
        init_method = f"tcp://{coordinator_address}"
        kw = {"world_size": 1 if num_processes is None else num_processes,
              "rank": process_id or 0}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    if device.type == "cuda":
        torch.cuda.set_device(_local_device(device))


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The sequence mesh over the ranks of the default group.  In a process
    that has joined none, a one-rank group on a free localhost port.
    ``n_devices``, if given, must be the number of ranks."""
    if not dist.is_initialized():
        initialize_distributed(f"localhost:{free_port()}", 1, 0,
                               device=device)
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"ranks; the group has {dist.get_world_size()}")
    return Mesh(_local_device(device))


def make_global_mesh(device="cuda") -> Mesh:
    """The mesh over every rank of a (possibly multi-host) group, in rank
    order, so neighbouring sequence blocks sit on one host."""
    return make_mesh(None, device)


def host_local_batch_slice(n_sequences: int) -> slice:
    """The contiguous block of the global sequence axis this rank owns.
    ``n_sequences`` must divide over the ranks; otherwise trailing sequences
    would be owned by no rank."""
    procs = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_sequences % procs != 0:
        raise ValueError(
            f"n_sequences={n_sequences} does not divide over {procs} "
            "processes; pad or drop the remainder explicitly")
    per = n_sequences // procs
    return slice(rank * per, (rank + 1) * per)


# ---- trees: dicts, lists, tuples and named tuples of tensors ----

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    out = []
    tree_map(out.append, tree)
    return out


def stack(trees: List[Any]) -> Any:
    """Per-sequence trees of one structure -> one tree whose leaves have a
    leading sequence axis."""
    leaves = [tree_leaves(t) for t in trees]
    it = iter([torch.stack([torch.as_tensor(x[i]) for x in leaves])
               for i in range(len(leaves[0]))])
    return tree_map(lambda _: next(it), trees[0])


def _row(tree, s):
    """Sequence ``s`` of a list of per-sequence trees or of a stacked
    tree."""
    if isinstance(tree, list):
        return tree[s]
    return tree_map(lambda x: x[s], tree)


def min_max_over_ranks(values: Dict[str, int]) -> Dict[str, tuple]:
    """{name: (min, max)} of each integer over the ranks: one collective."""
    v = list(values.values())
    t = torch.tensor([x for a in v for x in (a, -a)], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    t = t.tolist()
    return {k: (-t[2 * i + 1], t[2 * i]) for i, k in enumerate(values)}


def collective_device() -> torch.device:
    """NCCL reduces tensors on the rank's GPU, gloo on the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """A tree with the GLOBAL sequence axis leading -> this rank's rows
    (``host_local_batch_slice``), on the rank's device."""
    leaves = tree_leaves(tree)
    n = {int(torch.as_tensor(x).shape[0]) for x in leaves}
    if len(n) != 1:
        raise ValueError(f"leaves disagree on the sequence axis: {n}")
    own = host_local_batch_slice(n.pop())
    return tree_map(lambda x: torch.as_tensor(x)[own].to(mesh.device), tree)


def global_shard_batch(mesh: Mesh, local_tree: Any) -> Any:
    """Each rank's own rows (``host_local_batch_slice``) -> on its device.
    Every rank must pass the same number of rows."""
    rows = {int(torch.as_tensor(x).shape[0]) for x in tree_leaves(local_tree)}
    if len(rows) != 1:
        raise ValueError(f"leaves disagree on the sequence axis: {rows}")
    lo, hi = min_max_over_ranks({"rows": rows.pop()})["rows"]
    if lo != hi:
        raise ValueError(f"ranks hold {lo} to {hi} sequences; each must "
                         "hold as many")
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), local_tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """The tree on the rank's device, broadcast from rank 0: every rank must
    pass bitwise equal values, and all raise if one does not."""
    leaves = [torch.as_tensor(x).to(mesh.device) for x in tree_leaves(tree)]
    coll = collective_device()
    out, differs = list(leaves), []
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx]).to(coll)
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        differs.append((ref.view(torch.uint8)
                        != flat.view(torch.uint8)).any())
        parts = ref.to(mesh.device).split([leaves[i].numel() for i in idx])
        for i, p in zip(idx, parts):
            out[i] = p.view(leaves[i].shape)
    differs = torch.stack(differs).any().long() if differs else (
        torch.zeros((), dtype=torch.int64, device=coll))
    dist.all_reduce(differs, op=dist.ReduceOp.MAX)
    if int(differs):
        raise ValueError("replicate: the ranks passed different values")
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def global_replicate(mesh: Mesh, tree: Any) -> Any:
    """``replicate`` over a multi-host group: every process passes the same
    values (parameters, constants).  One process owns one device here, so
    it is the same operation."""
    return replicate(mesh, tree)


def all_reduce_sum(tensors: List[torch.Tensor],
                   record: Optional[Dict] = None) -> List[torch.Tensor]:
    """Sum ``tensors`` over the ranks as one flat float32 buffer in one
    collective, in list order; returns the float32 sums.  ``record`` gets
    the collective's 'ms' (CUDA events on the card, the host clock on the
    CPU), 'bytes' and 'clock'."""
    device = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    timed = device.type == "cuda"
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    # gloo reduces on the host: the copies are part of the collective
    coll = flat.to(collective_device())
    dist.all_reduce(coll, op=dist.ReduceOp.SUM)
    flat = coll.to(device)
    if timed:
        ev[1].record()
        ev[1].synchronize()
    ms = ev[0].elapsed_time(ev[1]) if timed else (
        time.perf_counter() - t0) * 1e3
    if record is not None:
        record.update(ms=ms, bytes=flat.numel() * flat.element_size(),
                      clock="cuda_events" if timed else "host")
    parts = flat.split([t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def sequence_means(mesh: Mesh, losses: torch.Tensor, grads, record=None):
    """This rank's per-sequence ``losses`` (n, ...) and its ``grads`` summed
    over its n sequences -> every rank's losses (N, ...) in global order and
    the gradients' mean over all N = n x ranks sequences (every rank holds
    as many, ``host_local_batch_slice``): one all-reduce of one buffer, the
    losses placed at this rank's rows and zero elsewhere, the gradients in
    sorted name order."""
    n = losses.shape[0]
    N = n * mesh.size
    rows = losses.detach().new_zeros((N,) + tuple(losses.shape[1:]))
    rows[mesh.rank * n:(mesh.rank + 1) * n] = losses.detach()
    names = sorted(grads) if grads is not None else []
    out = all_reduce_sum([rows] + [grads[k] for k in names], record)
    if grads is not None:
        grads = {k: (g / N).to(grads[k].dtype)
                 for k, g in zip(names, out[1:])}
    return out[0].to(losses.dtype), grads


def run_local_sequences(fn, model, denoiser, batches, imu_wins, init_states,
                        consts, prev_motions=None, backward_events=None,
                        **kw):
    """``fn`` (``train_step`` or ``train_scan``) on each of this rank's
    sequences in turn, with its own window inputs, init state,
    calibration ``consts`` (rgb2imu_pose, gravity, accel_bias, gyro_bias,
    subtract_bias) and replayed motions.  Inputs are lists of per-sequence
    trees or stacked trees.  Returns (losses stacked per sequence, the
    gradients summed over the sequences or None, aux stacked per sequence,
    'carry' an ``IMUState`` of stacked tensors)."""
    n = len(init_states) if isinstance(init_states, list) else int(
        init_states.pos.shape[0])
    losses, auxs, grads = [], [], None
    for s in range(n):
        loss, g, aux = fn(
            model, _row(batches, s), _row(imu_wins, s), _row(init_states, s),
            *(_row(c, s) for c in consts), denoiser=denoiser,
            prev_motions=None if prev_motions is None else _row(
                prev_motions, s),
            backward_events=(None if backward_events is None
                             else backward_events[s]), **kw)
        grads = add_grads(grads, g)
        losses.append(loss)
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs])
           for k in auxs[0] if k != "carry"}
    aux["carry"] = IMUState(*(torch.stack(x) for x in zip(
        *(a["carry"] for a in auxs))))
    return torch.stack(losses), grads, aux


def multi_sequence_train_step(mesh: Mesh, **static_kwargs):
    """The multi-sequence window step.

    Returns step(model, denoiser, batches, imu_wins, init_states,
    rgb2imu_pose, gravity, accel_bias, gyro_bias, subtract_bias,
    prev_motions, record=None, backward_events=None) -> (loss, grads,
    aux): ``train_step`` with ``static_kwargs`` (target, datatype, bf16,
    bilevel, concat_free, ...) on each of this rank's sequences, whose
    inputs lead with the local sequence axis (``shard_batch``,
    ``global_shard_batch``, or lists).  The calibration constants are per
    sequence too: ``rgb2imu_pose`` (n, 7), ``gravity`` (n,),
    ``accel_bias``/``gyro_bias`` (n, 3), ``subtract_bias`` (n,);
    ``prev_motions`` is None or (n, B, 7).  ``loss`` and ``grads`` are the
    means over all N sequences of every rank (one all-reduce,
    ``sequence_means``; ``record`` gets its ms and bytes); ``aux`` holds
    this rank's sequences.  ``backward_events``: per local sequence, a pair
    of CUDA events for ``train_step``.
    """
    def step(model, denoiser, batches, imu_wins, init_states, rgb2imu_pose,
             gravity, accel_bias, gyro_bias, subtract_bias,
             prev_motions=None, record=None, backward_events=None):
        losses, grads, aux = run_local_sequences(
            train_step, model, denoiser, batches, imu_wins, init_states,
            (rgb2imu_pose, gravity, accel_bias, gyro_bias, subtract_bias),
            prev_motions, backward_events, **static_kwargs)
        losses, grads = sequence_means(mesh, losses, grads, record)
        return losses.mean(), grads, aux

    return step


def multi_sequence_train_scan(mesh: Mesh, **static_kwargs):
    """The fused-chunk variant of ``multi_sequence_train_step``:
    ``train_scan`` (K windows, nothing read back between them) on each of
    this rank's sequences; ``batches``/``imu_wins`` per sequence lead with
    K (a list of K windows or stacked), ``prev_motions`` is None or (n, K,
    B, 7), ``backward_events`` per local sequence K pairs.  Returns (every
    rank's losses (N, K) in global order, the gradients summed over the
    windows and averaged over all N sequences, aux per local sequence with
    its tail 'carry'): one all-reduce a chunk."""
    def step(model, denoiser, batches, imu_wins, init_states, rgb2imu_pose,
             gravity, accel_bias, gyro_bias, subtract_bias,
             prev_motions=None, record=None, backward_events=None):
        losses, grads, aux = run_local_sequences(
            train_scan, model, denoiser, batches, imu_wins, init_states,
            (rgb2imu_pose, gravity, accel_bias, gyro_bias, subtract_bias),
            prev_motions, backward_events, **static_kwargs)
        losses, grads = sequence_means(mesh, losses, grads, record)
        return losses, grads, aux

    return step
