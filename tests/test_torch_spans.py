"""The port's ranges and its preparation record: what a profiler sees of
``Trainer.run_epoch``, and what ``Trainer.prepare`` counts.

Port only.  On the CPU at 64x128, B=2, 2 windows (5 synthetic frames),
each epoch with snapshots (``bi < 10``: after every window).  The main
thread's ``islam::`` ranges are read from a ``torch.profiler`` run with CPU
activities and compared, order and nesting, with the documented layout: a
window is ``prefetch_wait`` (its inline ``prepare`` where nothing was
prefetched), ``step`` (``vo_forward``, ``imu``, ``pvgo``, ``backward``,
``guard`` a window), ``sync``, then ``flush`` and ``snapshot``; the epoch
ends with ``flush``, ``optimizer`` and ``snapshot``.  The prefetch runs
(two cores forced), so window 0 prepares inline and window 1 takes what the
worker thread prepared; that thread's ranges are not on the main thread.
"""

import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from islam_tpu_torch import train as ttrain
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.denoiser import init_denoiser

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

H, W, B = 64, 128, 2
FRAMES = 2 * B + 1
FLAGS = ["--data-type", "synthetic", "--image-height", str(H),
         "--image-width", str(W), "--batch-size", str(B),
         "--synthetic-frames", str(FRAMES), "--loss-weight", "(1,0.1,10,0.1)",
         "--trans-w", "0.1", "--print-interval", "0", "--device", "cpu"]
STEP = ["vo_forward", "imu", "pvgo", "backward", "guard"]


def _trainer(pkl, *flags):
    ds = SyntheticTrajDataset(num_frames=FRAMES, height=H, width=W,
                              transform=ttrain.make_transform(H, W))
    return ttrain.Trainer(get_args([*FLAGS, "--imu-denoise-model-name", pkl,
                                    *flags]), ds, device="cpu")


def _tree(events):
    """The main thread's ``islam::`` ranges as nested [(name, children)],
    names without the prefix, in order of their start.  ``events``: the
    profiler's raw events (building ``FunctionEvent``s takes longer than
    the epochs)."""
    spans = [e for e in events if e.name().startswith("islam::")]
    main = next(e.start_thread_id() for e in spans
                if e.name() == "islam::step")
    spans = sorted((e.start_ns(), -e.start_ns() - e.duration_ns(),
                    e.name()[7:])
                   for e in spans if e.start_thread_id() == main)
    root, stack = [], []
    for start, neg_end, name in spans:
        while stack and stack[-1][0] <= start:
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else root).append(node)
        stack.append((-neg_end, node))
    return root


def _expected(steps, trains):
    """The layout of an epoch: ``steps`` holds, for each window or chunk,
    the inline ``prepare`` calls inside its ``prefetch_wait`` and its
    step's children; ``trains``: the epoch ends with the optimizer."""
    out = []
    for inline, children in steps:
        out += [("prefetch_wait", [("prepare", [])] * inline),
                ("step", [(n, []) for n in children]),
                ("sync", []), ("flush", []), ("snapshot", [])]
    return out + [("flush", [])] + (
        [("optimizer", [])] if trains else []) + [("snapshot", [])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 'vo' epoch unprofiled and profiled window by window, profiled with
    --scan-chunk 2 (one chunk of both windows), and a profiled
    --eval-only epoch; each with the prefetch on."""
    tmp = tmp_path_factory.mktemp("spans")
    pkl = str(tmp / "denoiser.pkl")
    torch.save(init_denoiser(1, "cpu").state_dict(), pkl)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "cpu_count", lambda: 2)
        for name, flags, epoch, profiled in (
                ("plain", (), 1, False),
                ("per_window", (), 1, True),
                ("scan_chunk", ("--scan-chunk", "2"), 1, True),
                ("eval_only", ("--eval-only",), 0, True)):
            tr = _trainer(pkl, "--worker-num", "1", *flags)
            snap = str(tmp / name)
            if profiled:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    tr.run_epoch(epoch, snapshot_dir=snap)
                events = list(prof.profiler.kineto_results.events())
            else:
                tr.run_epoch(epoch, snapshot_dir=snap)
                events = None
            out[name] = {"trainer": tr, "snap": snap, "events": events}
    return out


EVAL_STEP = [n for n in STEP if n != "backward"]
EXPECTED = {
    "per_window": _expected([(1, STEP), (0, STEP)], True),
    # one chunk: both windows prepared inline, one step of the two
    "scan_chunk": _expected([(2, STEP * 2)], True),
    "eval_only": _expected([(1, EVAL_STEP), (0, EVAL_STEP)], False),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_main_thread_ranges_in_order(runs, name):
    assert _tree(runs[name]["events"]) == EXPECTED[name]


def test_profiler_changes_no_trajectory(runs):
    """The same 'vo' epoch with the profiler on and off: the snapshots and
    the updated pose head, bitwise."""
    plain, traced = runs["plain"], runs["per_window"]
    files = sorted(os.listdir(os.path.join(plain["snap"], "1")))
    assert "vo_motion.txt" in files and "pgo_pose.txt" in files
    for f in files:
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(plain["snap"], "1", f)),
            np.loadtxt(os.path.join(traced["snap"], "1", f)), err_msg=f)
    for k, p in plain["trainer"].vo_params.items():
        assert torch.equal(p, traced["trainer"].vo_params[k]), k


@pytest.mark.parametrize("name", ["per_window", "scan_chunk", "eval_only"])
def test_synthetic_records_decode_nothing(runs, name):
    """Rendered frames: every window's record counts no image and no
    decode second, and keeps the split's keys."""
    tr = runs[name]["trainer"]
    recs = tr.prep_split_seconds[0 if name == "eval_only" else 1]
    assert len(recs) == 2
    for r in recs:
        assert set(r) == {"decode", "transforms", "copy", "images", "cpu"}
        assert r["images"] == 0 and r["decode"] == 0.0 and r["cpu"] > 0


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A trainer over a KITTI fixture of 6 frames, 4 pairs (60x120, cropped and
    upscaled to 64x128)."""
    from islam_tpu_torch.data import fixtures
    from islam_tpu_torch.data.dataset import TrajFolderDataset
    tmp = tmp_path_factory.mktemp("kitti")
    root = fixtures.write_kitti(str(tmp / "seq"), n=FRAMES + 1, h=60,
                                w=120)
    ds = TrajFolderDataset(root, "kitti",
                           transform=ttrain.make_transform(H, W))
    args = get_args(["--data-type", "kitti", "--data-root", root,
                     "--batch-size", str(B), "--image-height", str(H),
                     "--image-width", str(W), "--device", "cpu"])
    return ttrain.Trainer(args, ds, device="cpu")


# the record's 'cpu' and its wall time come from two clocks: their
# granularity, not the thread's work
CLOCK_SLACK = 1e-3


@pytest.mark.parametrize("bi", [0, 1])
def test_kitti_record_counts_its_images_and_cpu(kitti, bi):
    """A window of consecutive pairs decodes each distinct frame once: B+1
    left and B right frames, 2 B + 1 images; the thread's CPU seconds lie
    within the wall time of decode and transforms."""
    split = kitti.prepare(bi)[3]
    assert split["images"] == 2 * B + 1
    assert split["decode"] > 0 and split["transforms"] > 0
    assert 0 < split["cpu"] <= (split["decode"] + split["transforms"]
                                + CLOCK_SLACK)


def test_kitti_record_is_its_own_call(kitti):
    """Windows prepared while another thread decodes other samples: each
    record holds its own images only, and no more decode seconds than its
    own wall time."""
    stop = threading.Event()
    decoded = []

    def decode_meanwhile():
        while not stop.is_set():
            tally = {"images": 0, "decode": 0.0}
            kitti.dataset.sample(2, tally)
            decoded.append(tally)

    t = threading.Thread(target=decode_meanwhile, daemon=True)
    t.start()
    try:
        splits = [kitti.prepare(bi)[3] for bi in (0, 1)]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert decoded, "the other thread decoded while the windows were made"
    assert all(d["images"] == 4 for d in decoded)
    for split in splits:
        assert split["images"] == 2 * B + 1
        assert split["decode"] > 0 and split["transforms"] > 0
