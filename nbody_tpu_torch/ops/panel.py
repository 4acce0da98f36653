"""The far-sweep panel written three ways: the plain versions of the
panel-sweep kernel (csrc/panel.cu through ops/cuda/panel.py), ported from
tools/_prof_mxu.py.

A panel is B = 256 targets against a chunk of LC = 1024 planar sources
(x, y, z, m) under the v5 force law with softening SOFT = 50:
  * vpu:   a = sum_j w_j d_j with d = q - p, w = m / (|d|^2 + SOFT)^{3/2};
  * mxu:   S = sum_j w_j [1, q_j], a = S[1:4] - p S[0] (the identity that
           lets a matrix unit form S, at the price of float32 cancellation
           at the coordinates' scale);
  * mxu_c: mxu with targets and sources centred on the panel's mean
           target, so the cancellation happens at the distance scale.
`sweep` adds the panels of every chunk, in chunk order, per 256-target
tile.
"""

from __future__ import annotations

import torch

B = 256
LC = 1024
SOFT = 50.0
VARIANTS = ("vpu", "mxu", "mxu_c")


def _weights(dx, dy, dz, qm):
    d2 = dx * dx + dy * dy + dz * dz
    inv = torch.rsqrt(d2 + SOFT)
    return qm * (inv * inv * inv)


def panel_vpu(p, qx, qy, qz, qm):
    """p [..., B, 3] targets against sources q* [LC] -> [..., B, 3]."""
    dx = qx - p[..., 0:1]
    dy = qy - p[..., 1:2]
    dz = qz - p[..., 2:3]
    w = _weights(dx, dy, dz, qm)
    return torch.stack([(w * dx).sum(-1), (w * dy).sum(-1),
                        (w * dz).sum(-1)], dim=-1)


def panel_mxu(p, qx, qy, qz, qm):
    dx = qx - p[..., 0:1]
    dy = qy - p[..., 1:2]
    dz = qz - p[..., 2:3]
    w = _weights(dx, dy, dz, qm)
    s = torch.stack([w.sum(-1), (w * qx).sum(-1), (w * qy).sum(-1),
                     (w * qz).sum(-1)], dim=-1)
    return s[..., 1:4] - p * s[..., 0:1]


def _centred(p, qx, qy, qz):
    """Targets and sources relative to the panel's mean target."""
    c = p.mean(dim=-2, keepdim=True)                     # [..., 1, 3]
    return (p - c, qx - c[..., 0:1], qy - c[..., 1:2], qz - c[..., 2:3])


def panel_mxu_c(p, qx, qy, qz, qm):
    pc, qxc, qyc, qzc = _centred(p, qx, qy, qz)
    return panel_mxu(pc, qxc, qyc, qzc, qm)


PANELS = {"vpu": panel_vpu, "mxu": panel_mxu, "mxu_c": panel_mxu_c}


def _chunked(fn, pos3, gx, gy, gz, gm, tile_chunk):
    """fn(p, qx, qy, qz, qm) summed over the LC-source chunks in order,
    for blocks of `tile_chunk` tiles."""
    out = []
    for i in range(0, pos3.shape[0], tile_chunk):
        p = pos3[i:i + tile_chunk]
        acc = None
        for c in range(0, gx.shape[0], LC):
            part = fn(p, gx[c:c + LC], gy[c:c + LC], gz[c:c + LC],
                      gm[c:c + LC])
            acc = part if acc is None else acc + part
        out.append(acc)
    return torch.cat(out)


def sweep(panel, pos3, gx, gy, gz, gm, tile_chunk: int = 64):
    """Plain sweep: pos3 [t, B, 3], sources g* [g] (g a multiple of LC)
    -> [t, B, 3]."""
    if gx.shape[0] % LC:
        raise ValueError(f"{gx.shape[0]} sources are not a multiple of {LC}")
    return _chunked(panel, pos3, gx, gy, gz, gm, tile_chunk)


def term_scale(variant: str, pos3, gx, gy, gz, gm, tile_chunk: int = 64):
    """Per target, the magnitude of the terms its sweep adds up, [t, B]:
    sum |w| |d| for vpu, sum |w| (|q| + |p|) for mxu and (centred) mxu_c.
    A sum of float32 terms is off by a few ulps of this, whatever the
    order, so errors are normalised by it."""

    def norm(x, y, z):
        return torch.sqrt(x * x + y * y + z * z)

    def scale(p, qx, qy, qz, qm):
        if variant == "mxu_c":
            p, qx, qy, qz = _centred(p, qx, qy, qz)
        dx = qx - p[..., 0:1]
        dy = qy - p[..., 1:2]
        dz = qz - p[..., 2:3]
        w = _weights(dx, dy, dz, qm).abs()
        if variant == "vpu":
            return (w * norm(dx, dy, dz)).sum(-1)
        return (w * norm(qx, qy, qz)).sum(-1) + w.sum(-1) * norm(
            p[..., 0], p[..., 1], p[..., 2])

    return _chunked(scale, pos3, gx, gy, gz, gm, tile_chunk)
