"""Point-splat renderer on the simulation's device.

The reference's CUDA -> OpenGL path (nbody_v5.cu:278-356:
updateVisualsKernel and fixed-pipeline GL_POINTS) becomes a camera
transform and a scatter rasterisation into an RGB framebuffer tensor.

  * speed colormap: t = min(|v|/150, 1), rgb = (0.4+0.6t, 0.3+0.4t,
    1.0-0.7t) (nbody_v5.cu:287-290);
  * camera: eye at (0, 0, camDistance) looking at the origin, +y up,
    rotX about x then rotY about y (nbody_v5.cu:340-342); perspective
    fov 45 deg, near 10, far 1e6 (nbody_v5.cu:472-473);
  * default orbit rotX 30, rotY 45, distance 4000 (nbody_v5.cu:35-36).

Two composite modes:
  * "add"   additive splats (``index_add_``), clipped to [0, 1];
  * "depth" nearest point wins: a scatter-min z-buffer
            (``scatter_reduce_(..., "amin")``), then every particle at
            its pixel's minimum depth adds its colour and ties average
            (the reference's GL_DEPTH_TEST points, nbody_v5.cu:475).
On CUDA the scatter-adds are float atomics, so the order of the adds
into one pixel, and so its last bits, varies from run to run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState

_BIG = 3.0e38


def speed_colormap(vel: torch.Tensor) -> torch.Tensor:
    """[N, 3] velocities -> [N, 3] rgb in [0, 1] (nbody_v5.cu:286-290)."""
    speed = torch.sqrt((vel * vel).sum(dim=1))
    t = torch.clamp(speed / 150.0, max=1.0)
    return torch.stack([0.4 + 0.6 * t, 0.3 + 0.4 * t, 1.0 - 0.7 * t], dim=1)


def _rotation(rot_x_deg: float, rot_y_deg: float) -> np.ndarray:
    """R = Rx(rot_x) @ Ry(rot_y) in float32, on the host."""
    f32 = np.float32
    rx, ry = (f32(d) * f32(np.pi / 180.0) for d in (rot_x_deg, rot_y_deg))
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], f32)
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], f32)
    return r_x @ r_y


def project(pos: torch.Tensor, cam_distance: float, rot_x_deg: float,
            rot_y_deg: float, width: int, height: int, fov_deg: float = 45.0,
            near: float = 10.0, far: float = 1.0e6):
    """World positions -> (pixel_x, pixel_y, eye_depth, visible_mask).
    The rotation is applied as scalar multiply-adds, so a frame copies
    nothing to the device (a copy would wait for the stream)."""
    r = _rotation(rot_x_deg, rot_y_deg).tolist()
    x, y, zw = pos[:, 0], pos[:, 1], pos[:, 2]

    def row(k):
        return x * r[k][0] + y * r[k][1] + zw * r[k][2]

    ex, ey = row(0), row(1)
    z = -(row(2) - cam_distance)           # lookAt(0,0,d): translate by -d
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    aspect = width / height
    safe_z = torch.clamp(z, min=1e-6)
    ndc_x = (f / aspect) * ex / safe_z
    ndc_y = f * ey / safe_z
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height
    ix = torch.floor(px).to(torch.int64)
    iy = torch.floor(py).to(torch.int64)
    visible = ((z > near) & (z < far) & (ix >= 0) & (ix < width) & (iy >= 0)
               & (iy < height))
    return ix, iy, z, visible


def render_frame(pos: torch.Tensor, vel: torch.Tensor, cam_distance: float,
                 rot_x_deg: float, rot_y_deg: float, width: int = 1280,
                 height: int = 720, mode: str = "add",
                 exposure: float = 1.0) -> torch.Tensor:
    """Render an [H, W, 3] float32 frame in [0, 1] on pos's device."""
    if mode not in ("add", "depth"):
        raise ValueError(f"unknown mode {mode}")
    ix, iy, z, vis = project(pos, cam_distance, rot_x_deg, rot_y_deg, width,
                             height)
    rgb = speed_colormap(vel)
    # invisible particles add zero to pixel 0 (no host read to drop them)
    flat = torch.where(vis, iy * width + ix, 0)
    npix = width * height
    one = vis.to(torch.float32)
    fb = pos.new_zeros((npix, 3))
    if mode == "add":
        fb.index_add_(0, flat, (one * exposure)[:, None] * rgb)
        return torch.clamp(fb, 0.0, 1.0).reshape(height, width, 3)
    zval = torch.where(vis, z, torch.full_like(z, _BIG))
    zbuf = torch.full((npix,), _BIG, dtype=torch.float32, device=pos.device)
    zbuf.scatter_reduce_(0, flat, zval, "amin")
    # a particle owns its pixel iff its depth is the buffered minimum
    owns = (vis & (zval <= zbuf[flat])).to(torch.float32)
    cnt = pos.new_zeros(npix).index_add_(0, flat, owns)
    fb.index_add_(0, flat, owns[:, None] * rgb)
    fb = fb / torch.clamp(cnt, min=1.0)[:, None]     # average depth ties
    return fb.reshape(height, width, 3)


def render_state(state: ParticleState, cfg: SimConfig, mode: str = "add",
                 exposure: float = 1.0) -> torch.Tensor:
    return render_frame(state.pos, state.vel, cfg.cam_distance,
                        cfg.cam_rot_x, cfg.cam_rot_y, cfg.render_width,
                        cfg.render_height, mode, exposure)


def write_ppm(path: str, frame) -> None:
    """Binary PPM (P6) of an [H, W, 3] frame in [0, 1] (tensor or
    array)."""
    f = torch.as_tensor(frame).detach().cpu().numpy().astype(np.float32)
    img = (np.clip(f, 0, 1) * np.float32(255.0)).astype(np.uint8)
    h, w, _ = img.shape
    with open(path, "wb") as out:
        out.write(f"P6 {w} {h} 255\n".encode())
        out.write(img.tobytes())


class OrbitCamera:
    """Host-side camera mirroring the GLUT callbacks
    (nbody_v5.cu:460-469): a drag rotates 0.2 deg per pixel, a scroll
    click zooms by 150."""

    def __init__(self, cfg: SimConfig):
        self.distance = cfg.cam_distance
        self.rot_x = cfg.cam_rot_x
        self.rot_y = cfg.cam_rot_y

    def drag(self, dx_px: float, dy_px: float) -> None:
        self.rot_y += dx_px * 0.2
        self.rot_x += dy_px * 0.2

    def scroll(self, clicks: int) -> None:
        self.distance -= 150.0 * clicks
