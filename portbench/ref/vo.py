"""The VO front-end of the plain reference: a window's network inputs made
from the drive's files, and TartanVO's forward after the networks
(TartanVO.py:90-198): de-normalisation, the metric scale from stereo
disparity and flow, and the camera-to-IMU conjugation of train.py.

The scale's least squares and the frame conversions run in float64; the
Sobel edge mask runs in float32, as the port computes it, so that a pixel
at the threshold falls the same way on both sides.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.ref import images, lie
from portbench.ref.loaders import LOADERS

POSE_STD = (0.13, 0.13, 0.13, 0.013, 0.013, 0.013)
DISP_TH = {"kitti": 5.0, "euroc": 1.0}
# NED (TartanAir) -> camera-forward (KITTI) axes
T2K = np.array([[0., 1., 0.], [0., 0., 1.], [1., 0., 0.]])


class Drive:
    """A drive folder parsed by the reference loaders, and the network
    inputs of its windows at the crop size (h, w)."""

    def __init__(self, root: str, datatype: str, h: int, w: int):
        self.seq = LOADERS[datatype](root)
        self.datatype, self.h, self.w = datatype, h, w

    def _image(self, path, right=False):
        img = images.read_image(path)
        if self.seq.require_undistort:
            m = self.seq.imgmap_right if right else self.seq.imgmap
            img = images.remap_linear_u8(img, m[0], m[1])
        return img

    def window(self, st: int, B: int, device):
        """Frames st .. st + B: NCHW float32 tensors on ``device`` (frames
        /255 BGR (B + 1), left and right normalised (B), the 1/4 ray map
        (B)), the 1/4-scale intrinsics (4,) and the stereo baseline, as
        float64."""
        seq, h, w = self.seq, self.h, self.w
        lefts = [self._image(seq.rgbfiles[i]) for i in range(st, st + B + 1)]
        rights = [self._image(seq.rgbfiles_right[i], True)
                  for i in range(st, st + B)]
        H0, W0 = lefts[0].shape[:2]
        size, y1, x1 = images.crop_plan(H0, W0, h, w)
        ray = images.ray_map(W0, H0, *seq.intrinsic)
        calib = np.asarray(seq.intrinsic, np.float64).copy()
        if size is not None:
            rh, rw = size
            lefts = [images.resize_linear_u8(x, rh, rw) for x in lefts]
            rights = [images.resize_linear_u8(x, rh, rw) for x in rights]
            t = torch.from_numpy(ray).permute(2, 0, 1)[None]
            ray = F.interpolate(t, size=(rh, rw), mode="bilinear",
                                align_corners=False)[0].permute(1, 2, 0)
            ray = ray.numpy()
            sw, sh = rw / W0, rh / H0
            calib *= np.array([sw, sh, sw, sh])
        calib[2] -= x1
        calib[3] -= y1

        def crop(x):
            return x[y1:y1 + h, x1:x1 + w]

        scale = np.float32(1) / np.float32(255)
        mean = np.asarray(images.MEAN, np.float32)
        inv_std = np.float32(1) / np.asarray(images.STD, np.float32)

        def raw(x):
            return crop(x).astype(np.float32) * scale

        def nchw(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.stack(a).transpose(0, 3, 1, 2))).to(device)

        frames = [raw(x) for x in lefts]
        norm = [(f - mean) * inv_std for f in frames[:-1]]
        rnorm = [(raw(x) - mean) * inv_std for x in rights]
        ray = crop(ray)[::4, ::4]
        return {"frames": nchw(frames), "img0_norm": nchw(norm),
                "img0_r_norm": nchw(rnorm),
                "intrinsic": nchw([ray] * B),
                "calib": calib / 4.0,
                "baseline": float(np.linalg.norm(
                    np.asarray(seq.right2left_pose[:3], np.float64)))}


def edge_mask(img, low=50.0, dilate=5):
    """Sobel magnitude over ``low``, dilated by a 5 x 5 square (the port's
    stand-in for cv2.Canny(50, 100) + dilate), in float32; img (B, 3, H, W)
    BGR in [0, 1]."""
    gray = (0.114 * img[:, 0] + 0.587 * img[:, 1] + 0.299 * img[:, 2]) * 255.0
    kx = torch.tensor([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                      dtype=gray.dtype, device=gray.device)
    g = F.conv2d(gray[:, None], torch.stack([kx, kx.T])[:, None], padding=1)
    mag = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])
    dil = F.max_pool2d((mag > low).to(gray.dtype)[:, None], dilate, stride=1,
                       padding=dilate // 2)
    return dil[:, 0] > 0


def _conj(T, q):
    """T q T^-1 for a 3 x 3 rotation T (float64) and SE3 rows q."""
    Tq = lie.matrix_to_quat(torch.as_tensor(T, dtype=q.dtype,
                                            device=q.device))
    Tq = torch.cat([torch.zeros(3, dtype=q.dtype, device=q.device), Tq])
    return lie.se3_mul(Tq[None], lie.se3_mul(q, lie.se3_inv(Tq)[None]))


def motions(net, inp, datatype, rgb2imu_pose):
    """The window's VO motions in the IMU frame, (B, 7) float64 on the
    card, with the extras {'flow', 'disp' (network units), 'scale'}.  The
    pose head's parameters keep their gradients."""
    flow, disp, pose = net(inp["frames"], inp["img0_norm"],
                           inp["img0_r_norm"], inp["intrinsic"])
    dev = pose.device
    p = pose.double() * torch.tensor(POSE_STD, dtype=torch.float64,
                                     device=dev)
    trans = p[:, :3] / torch.clamp(torch.linalg.norm(p[:, :3], dim=1,
                                                     keepdim=True), min=1e-12)
    f = flow.double() * 5.0
    d = disp.double()[:, 0] * (50.0 / 4.0)
    pose_se3 = torch.cat([p[:, :3], lie.so3_exp(p[:, 3:])], dim=1)
    enu = _conj(T2K, pose_se3)
    small = F.interpolate(inp["frames"][:-1], size=flow.shape[-2:],
                          mode="bilinear", align_corners=False)
    mask = edge_mask(small)
    s = scale(d, f, enu, inp["calib"], inp["baseline"], mask,
              DISP_TH[datatype])
    m = torch.cat([trans * s[:, None], lie.so3_exp(p[:, 3:])], dim=1)
    m = _conj(T2K, m)
    T_IL = torch.as_tensor(np.asarray(rgb2imu_pose, np.float64), device=dev)
    out = lie.se3_mul(T_IL[None], lie.se3_mul(m, lie.se3_inv(T_IL)[None]))
    return out, {"flow": flow, "disp": disp, "scale": s}


def scale(disp, flow, motion, calib, baseline, mask, disp_th):
    """The per-pair metric scale (TartanVO.py / utils scale_from_disp_flow):
    each masked pixel's two flow equations in the unknown scale, solved by
    least squares.  disp (B, h, w) px, flow (B, 2, h, w) px, motion (B, 7)
    in ENU, calib [fx, fy, cx, cy] at this scale, float64."""
    B, _, H, W = flow.shape
    dev, dt = flow.device, flow.dtype
    fx, fy, cx, cy = (float(c) for c in calib)
    v, u = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                          torch.arange(W, dtype=dt, device=dev),
                          indexing="ij")
    warped_u, warped_v = flow[:, 0] + u, flow[:, 1] + v
    m = ((warped_u >= 0) & (warped_u <= W) & (warped_v >= 0)
         & (warped_v <= H) & (torch.linalg.norm(flow, dim=1) > 0) & mask)
    disp_ok = (u - disp >= 0) & (u - disp <= W) & (disp >= disp_th)
    m = m & disp_ok
    z = torch.where(disp_ok, fx * baseline / torch.clamp(disp, min=1e-6),
                    torch.zeros_like(disp))
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=dt,
                     device=dev)
    Kinv = torch.linalg.inv(K)
    P = z[..., None] * torch.einsum("ij,hwj->hwi", Kinv,
                                    torch.stack([u, v, torch.ones_like(u)],
                                                -1))[None]
    Tinv = lie.se3_inv(motion)
    t = Tinv[:, :3] / torch.clamp(torch.linalg.norm(Tinv[:, :3], dim=-1,
                                                    keepdim=True), min=1e-12)
    a = t @ K.T                                            # (B, 3)
    RP = lie.quat_rotate(Tinv[:, None, None, 3:], P)
    b = RP @ K.T                                           # (B, H, W, 3)
    fu, fv = warped_u, warped_v
    a0, a1, a2 = (a[:, i, None, None] for i in range(3))
    M1, w1 = a2 * fu - a0, b[..., 0] - b[..., 2] * fu
    M2, w2 = a2 * fv - a1, b[..., 1] - b[..., 2] * fv
    mf = m.to(dt)
    num = torch.sum(mf * (M1 * w1 + M2 * w2), dim=(1, 2))
    den = torch.sum(mf * (M1 * M1 + M2 * M2), dim=(1, 2))
    return num / torch.clamp(den, min=1e-12)
