"""A window made from its distinct frames (``TrajFolderDataset.window``)
against the collate of its pairs, bit for bit, and the dataset's shared ray
map (``TrajFolderDataset.rays``).

Port only; no JAX program.  Fixtures from ``islam_tpu_torch.data.fixtures``
at 60x120 (KITTI's frames are upscaled by ``CropCenter`` to 64x128; EuRoC's
are remapped), B = 3 pairs a window.  Equal means the same dtype, the same
shape and ``np.array_equal``, for every key ``train.device_batch`` reads and
'link' and 'dt', and for the device batch itself.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from islam_tpu_torch import train as ttrain
from islam_tpu_torch.data import dataset as tdataset
from islam_tpu_torch.data import fixtures, transforms

H, W, B = 64, 128, 3
FRAMES = 2 * B + 2
KEYS = ("img0", "img1", "img0_norm", "img0_r_norm", "intrinsic",
        "intrinsic_calib", "extrinsic", "motion", "link", "dt")


def _dataset(tmp, kind, transform=None, **kw):
    root = fixtures.WRITERS[kind](str(tmp), n=FRAMES, h=60, w=120)
    return tdataset.TrajFolderDataset(
        root, kind, transform=transform or ttrain.make_transform(H, W), **kw)


def _pairs(ds, start):
    tally = {"images": 0, "decode": 0.0}
    out = tdataset.collate([ds.sample(i, tally)
                            for i in range(start, start + B)])
    return out, tally


def _window(ds, start):
    tally = {"images": 0, "decode": 0.0}
    return ds.window(start, B, tally), tally


def _assert_equal(got, want, keys=KEYS):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("bi", [0, 1])
@pytest.mark.parametrize("kind", ["kitti", "euroc"])
def test_window_equals_the_pairs_collate(tmp_path, kind, bi):
    """2B+1 images decoded where the pairs decode 4B; every array the card
    reads, and the device batch, bit for bit the pairs'."""
    ds = _dataset(tmp_path, kind)
    assert ds.frames_apply(bi * B, B)
    got, tally = _window(ds, bi * B)
    want, want_tally = _pairs(ds, bi * B)
    assert tally["images"] == 2 * B + 1 and tally["decode"] > 0
    assert want_tally["images"] == 4 * B
    _assert_equal(got, want)
    for k in ("img1_r", "img1_norm", "img0_r"):
        assert k not in got, k
    gb = ttrain.device_batch(got, bi * B, "cpu")
    wb = ttrain.device_batch(want, bi * B, "cpu")
    assert set(gb) == set(wb) and "frames" in gb
    for k in wb:
        assert gb[k].dtype == wb[k].dtype and torch.equal(gb[k], wb[k]), k


@pytest.mark.parametrize("normalize", [
    {"keep_old": False}, {"keep_old": True, "rgbbgr": True}])
def test_window_follows_the_normalisation(tmp_path, normalize):
    """Other settings of the transform's own steps: a Normalize that keeps
    no /255 image (img1 is then normalised), or one that swaps channels."""
    tf = transforms.Compose([
        transforms.CropCenter((H, W), fix_ratio=True),
        transforms.DownscaleFlow(),
        transforms.Normalize(mean=ttrain.MEAN, std=ttrain.STD, **normalize),
        transforms.ToNHWCTensor()])
    ds = _dataset(tmp_path, "kitti", tf)
    got, tally = _window(ds, B)
    want, _ = _pairs(ds, B)
    assert tally["images"] == 2 * B + 1
    _assert_equal(got, want, [k for k in KEYS if k in want])
    assert set(got) >= {k for k in want if k in KEYS}


def test_window_refuses_frames_of_two_sizes(tmp_path, monkeypatch):
    """Each frame is transformed alone and the ray map is the first
    frame's, so a window whose frames differ in size is refused."""
    ds = _dataset(tmp_path, "kitti")
    undistort = ds.undistort
    monkeypatch.setattr(ds, "undistort", lambda img, is_right=False: (
        undistort(img, is_right)[:-2] if is_right else undistort(img)))
    with pytest.raises(AssertionError, match="differ in size"):
        ds.window(0, B)


class _Own:
    """A caller's own step: not one of make_transform's."""

    def __call__(self, sample):
        return sample


@pytest.mark.parametrize("case", ["links", "load_depth", "own_transform"])
def test_window_takes_the_pairs_path(tmp_path, case):
    """Non-consecutive links, flow or depth files, or a step of the
    caller's own: the pairs' collate, 4B images."""
    kind, kw = "kitti", {}
    if case == "links":
        kw["links"] = [[i, i + 2] for i in range(B)]
    elif case == "load_depth":
        kind, kw["load_depth"] = "tartanair", True
    else:
        kw["transform"] = transforms.Compose(
            [*ttrain.make_transform(H, W).transforms[:-1], _Own(),
             transforms.ToNHWCTensor()])
    if case == "load_depth":
        root = fixtures.write_tartanair(str(tmp_path), n=FRAMES, depth=True)
        ds = tdataset.TrajFolderDataset(
            root, kind, transform=ttrain.make_transform(H, W), **kw)
    else:
        ds = _dataset(tmp_path, kind, **kw)
    assert not ds.frames_apply(0, B)
    got, tally = _window(ds, 0)
    want, _ = _pairs(ds, 0)
    assert tally["images"] == 4 * B
    assert set(got) == set(want)
    _assert_equal(got, want, [k for k in KEYS if k in want])


def test_rays_made_once_and_read_only(tmp_path, monkeypatch):
    """The cached ray map and intrinsic_calib equal a pair's bit for bit,
    are made once however many windows are prepared, from four threads
    at once, and cannot be written."""
    ds = _dataset(tmp_path, "euroc")
    calls = []
    layer = tdataset.make_intrinsics_layer

    def counted(*a):
        calls.append(a)
        return layer(*a)

    monkeypatch.setattr(tdataset, "make_intrinsics_layer", counted)
    n = 4
    barrier = threading.Barrier(n)
    errors = []

    def prepare(starts):
        try:
            barrier.wait(timeout=30)
            for s in starts:
                ds.window(s, B)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=prepare,
                                args=([0, B, 0] if k % 2 else [B, 0, B],))
               for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    monkeypatch.setattr(tdataset, "make_intrinsics_layer", layer)
    pair = ds.sample(0)
    ray, calib = ds.rays(60, 120)
    _assert_equal({"intrinsic": ray, "intrinsic_calib": calib}, pair,
                  ["intrinsic", "intrinsic_calib"])
    for a in (ray, calib):
        with pytest.raises(ValueError):
            a[0] = 0
