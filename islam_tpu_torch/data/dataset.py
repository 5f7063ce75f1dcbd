"""Trajectory dataset over a sequence folder: consecutive stereo frame
pairs and their ground-truth motions, and the batching of samples.

Counterpart of ``islam_tpu/data/dataset.py`` (reference
Datasets/TrajFolderDataset.py:347-518): an indexable dataset and a
sequential window batcher (``iterate_batches``; shuffle=False,
drop_last=True, as the reference's DataLoader).  Images are decoded by
``image_io.read_image`` and undistorted by ``native.remap_linear_u8``, in
place of cv2.  ``sample(idx, tally)`` adds one sample's images and their
decode seconds to the caller's own tally, for the host-preparation record.
``load_flow`` and ``load_depth`` add the precomputed flow and depth a
TartanAir folder holds (``.npy``) as 'flow' and 'depth0'.  ``window(start,
B, tally)`` is a window's collated arrays, made from its distinct frames
where its links are consecutive (2B+1 images decoded, not the pairs' 4B).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List

import numpy as np
from scipy.spatial.transform import Rotation as R

from islam_tpu_torch.data import native
from islam_tpu_torch.data.image_io import read_image
from islam_tpu_torch.data.loaders import LOADERS, SequenceData
from islam_tpu_torch.data.transforms import (Compose, CropCenter,
                                             DownscaleFlow, Normalize,
                                             ToNHWCTensor,
                                             make_intrinsics_layer)
from islam_tpu_torch.transformation import relative_twists

# The steps of ``train.make_transform``: each acts on every key of a sample
# alone, sized by its first image, so a frame may be transformed alone.
_PER_KEY = (CropCenter, DownscaleFlow, Normalize, ToNHWCTensor)


class TrajFolderDataset:
    """Frame pairs of one KITTI, EuRoC or TartanAir sequence folder."""

    def __init__(self, datadir: str = None, datatype: str = 'tartanair',
                 transform=None, start_frame: int = 0, end_frame: int = -1,
                 loader: SequenceData = None, links=None,
                 load_flow: bool = False, load_depth: bool = False):
        self.load_flow = load_flow
        self.load_depth = load_depth
        if loader is None:
            loader = LOADERS[datatype](datadir)
        if end_frame <= 0:
            end_frame += len(loader.rgbfiles)

        self.datadir = datadir
        self.datatype = datatype
        self.transform = transform

        self.rgbfiles = loader.rgbfiles[start_frame:end_frame]
        self.rgb_dts = loader.rgb_dts[start_frame:end_frame - 1]
        self.rgb_ts = loader.rgb_ts[start_frame:end_frame]
        self.num_img = len(self.rgbfiles)

        self.rgbfiles_right = (loader.rgbfiles_right[start_frame:end_frame]
                               if loader.rgbfiles_right is not None else None)
        self.flowfiles = (loader.flowfiles[start_frame:end_frame - 1]
                          if loader.flowfiles is not None else None)
        self.depthfiles = (loader.depthfiles[start_frame:end_frame]
                           if loader.depthfiles is not None else None)

        self.intrinsic = loader.intrinsic
        self.intrinsic_right = loader.intrinsic_right
        self.right2left_pose = loader.right2left_pose

        self.poses = np.asarray(loader.poses)[start_frame:end_frame]
        self.vels = (np.asarray(loader.vels)[start_frame:end_frame]
                     if loader.vels is not None else None)

        self.has_imu = loader.has_imu
        if loader.has_imu:
            # IMU window realignment (TrajFolderDataset.py:401-420)
            self.rgb2imu_sync = loader.rgb2imu_sync[start_frame:end_frame].copy()
            start_imu = self.rgb2imu_sync[0]
            end_imu = self.rgb2imu_sync[-1] + 1
            self.rgb2imu_sync -= start_imu
            self.accels = loader.accels[start_imu:end_imu]
            self.gyros = loader.gyros[start_imu:end_imu]
            self.imu_dts = loader.imu_dts[start_imu:end_imu - 1]
            self.imu_ts = loader.imu_ts[start_imu:end_imu]
            self.rgb2imu_pose = loader.rgb2imu_pose
            self.imu_init = {'rot': self.poses[0, 3:],
                             'pos': self.poses[0, :3],
                             'vel': self.vels[0]}
            self.gravity = loader.gravity
            self.accel_bias = loader.accel_bias
            self.gyro_bias = loader.gyro_bias

        self.require_undistort = loader.require_undistort
        self.imgmap = loader.imgmap
        self.imgmap_right = loader.imgmap_right

        if links is None:
            self.links = [[i, i + 1] for i in range(self.num_img - 1)]
        else:
            self.links = links
        self.num_link = len(self.links)
        self.motions = relative_twists(self.poses, links=self.links
                                       ).astype(np.float32)
        # (h, w) -> the transformed intrinsic layer and intrinsic_calib of
        # a frame of that size, which all its pairs share (``rays``)
        self._rays = {}
        self._rays_lock = threading.Lock()

    def __len__(self):
        return self.num_link

    def __getitem__(self, idx):
        return self.sample(idx)

    def sample(self, idx, tally=None):
        """``self[idx]``; where ``tally`` ({'images': int, 'decode':
        seconds}) is given, the images this call decodes and their seconds
        are added to it."""
        return self.get_pair(self.links[idx][0], self.links[idx][1], tally)

    def undistort(self, img, is_right=False):
        """cv2.remap(img, *imgmap, INTER_AREA), which cv2 computes as
        INTER_LINEAR (``native.remap_linear_u8``, bit for bit)."""
        if not self.require_undistort:
            return img
        imgmap = self.imgmap_right if is_right else self.imgmap
        return native.remap_linear_u8(img, imgmap[0], imgmap[1])

    def _read(self, path, tally):
        t0 = time.perf_counter()
        img = read_image(path)
        if tally is not None:
            tally['images'] += 1
            tally['decode'] += time.perf_counter() - t0
        return img

    def get_pair(self, i, j, tally=None) -> Dict:
        """Load one frame pair (TrajFolderDataset.py:475-518); ``tally``
        as in ``sample``."""
        res = {'img0': [self.undistort(self._read(self.rgbfiles[i], tally))],
               'img1': [self.undistort(self._read(self.rgbfiles[j], tally))]}
        if self.rgbfiles_right is not None:
            res['img0_r'] = [self.undistort(
                self._read(self.rgbfiles_right[i], tally), True)]
            res['img1_r'] = [self.undistort(
                self._read(self.rgbfiles_right[j], tally), True)]
        # precomputed flow and depth (TartanVO.py:104,121-124)
        if self.load_flow and self.flowfiles is not None:
            res['flow'] = [np.load(self.flowfiles[min(i, j)])]
        if self.load_depth and self.depthfiles is not None:
            res['depth0'] = [np.load(self.depthfiles[i])]

        h, w, _ = res['img0'][0].shape
        res['intrinsic'] = [make_intrinsics_layer(w, h, *self.intrinsic)]
        res['intrinsic_calib'] = self.intrinsic.copy()

        if self.transform:
            res = self.transform(res)

        res['link'] = np.array([i, j])
        res['dt'] = np.sum(self.rgb_dts[min(i, j):max(i, j)])
        res['datatype'] = self.datatype
        res['motion'] = self._gt_motion_quat(i, j)
        if self.right2left_pose is not None:
            res['extrinsic'] = np.asarray(self.right2left_pose).copy()
        return res

    def window(self, start, B, tally=None) -> Dict:
        """Window [start, start+B): what ``collate([self.sample(i, tally)
        for i in range(start, start + B)])`` gives, bit for bit, for the
        keys ``train.device_batch`` reads and 'link' and 'dt'.

        Where ``frames_apply``, the window is made from its distinct
        frames: left frames start .. start+B and right frames start ..
        start+B-1 are decoded once each (2B+1 images into ``tally``) and
        transformed alone, and the ray map and intrinsic_calib are
        ``rays``'.  No 'img1_r' or 'img1_norm' is made.  Otherwise it is
        the pairs' collate (4B images).  A dataset's frames share one size.
        """
        pairs = range(start, start + B)
        if not self.frames_apply(start, B):
            return collate([self.sample(i, tally) for i in pairs])
        left = [self.undistort(self._read(self.rgbfiles[i], tally))
                for i in range(start, start + B + 1)]
        right = ([self.undistort(self._read(self.rgbfiles_right[i], tally),
                                 True) for i in pairs]
                 if self.rgbfiles_right is not None else [])
        hw = left[0].shape[:2]
        assert all(f.shape[:2] == hw for f in left + right), \
            "a window's frames differ in size"
        ray, calib = self.rays(*hw)
        outs = [self._transform_frame('img0', f) for f in left]
        rights = [self._transform_frame('img0_r', f, raw=False)
                  for f in right]
        samples = []
        for k, i in enumerate(pairs):
            res = dict(outs[k])
            res['img1'] = outs[k + 1]['img0']
            if rights:
                res.update(rights[k])
            res['intrinsic'] = ray
            res['intrinsic_calib'] = calib
            res['link'] = np.array([i, i + 1])
            res['dt'] = np.sum(self.rgb_dts[i:i + 1])
            res['motion'] = self._gt_motion_quat(i, i + 1)
            if self.right2left_pose is not None:
                res['extrinsic'] = np.asarray(self.right2left_pose)
            samples.append(res)
        return collate(samples)

    def frames_apply(self, start, B) -> bool:
        """Whether ``window(start, B)`` is made from its distinct frames:
        its links are [i, i+1], no flow or depth is loaded, and the
        transform is a ``Compose`` of ``_PER_KEY`` steps that ends in
        ``ToNHWCTensor`` and normalises at most once."""
        steps = getattr(self.transform, 'transforms', None)
        if (self.load_flow or self.load_depth
                or type(self.transform) is not Compose or not steps
                or any(type(t) not in _PER_KEY for t in steps)
                or type(steps[-1]) is not ToNHWCTensor
                or sum(type(t) is Normalize for t in steps) > 1):
            return False
        return all(tuple(self.links[i]) == (i, i + 1)
                   for i in range(start, start + B))

    def rays(self, h, w):
        """The transformed intrinsic layer and intrinsic_calib of an (h, w)
        frame, as every pair of that size has them: made once a size under
        a lock, for the prefetch thread and the main thread, and
        read-only."""
        with self._rays_lock:
            if (h, w) not in self._rays:
                res = self.transform({
                    'intrinsic': [make_intrinsics_layer(w, h,
                                                        *self.intrinsic)],
                    'intrinsic_calib': self.intrinsic.copy()})
                for k in ('intrinsic', 'intrinsic_calib'):
                    res[k].flags.writeable = False
                self._rays[(h, w)] = (res['intrinsic'],
                                      res['intrinsic_calib'])
            return self._rays[(h, w)]

    def _transform_frame(self, key, img, raw=True) -> Dict:
        """``self.transform`` of one frame under ``key`` alone;
        ``raw=False`` drops the /255 image that a ``keep_old`` Normalize
        keeps beside the normalised one."""
        sample = {key: [img]}
        for t in self.transform.transforms:
            sample = t(sample)
            if not raw and type(t) is Normalize and t.keep_old:
                del sample[key]
        return sample

    def _gt_motion_quat(self, i, j):
        Ti = np.eye(4)
        Ti[:3, :3] = R.from_quat(self.poses[i, 3:]).as_matrix()
        Ti[:3, 3] = self.poses[i, :3]
        Tj = np.eye(4)
        Tj[:3, :3] = R.from_quat(self.poses[j, 3:]).as_matrix()
        Tj[:3, 3] = self.poses[j, :3]
        M = np.linalg.inv(Ti) @ Tj
        q = R.from_matrix(M[:3, :3]).as_quat()
        return np.concatenate([M[:3, 3], q]).astype(np.float32)


def collate(samples: List[Dict]) -> Dict:
    """Stack a list of per-pair samples into batched numpy arrays."""
    out = {}
    for k in samples[0].keys():
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


def iterate_batches(dataset, batch_size: int, drop_last: bool = True
                    ) -> Iterator[Dict]:
    """Sequential window batcher (the reference's DataLoader access pattern:
    shuffle=False, drop_last=True)."""
    n = len(dataset)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield collate([dataset[i]
                       for i in range(start, min(start + batch_size, n))])
