"""Differentiable soft-silhouette rasterizer in plain PyTorch (counterpart of
hold_tpu/fitting/silhouette.py).

Per-pixel coverage is aggregated over ALL faces in log-space,

    alpha(p) = 1 - prod_f (1 - sigmoid(s_f(p) * d_f(p)^2 / sigma)),

where d_f is the 2D point-to-triangle distance in the projected NDC and
s_f = +1 inside / -1 outside (SoftRas's soft aggregation, exact over every
face).  The faces go in chunks of ``face_chunk``: each chunk's (B, pixels,
chunk) distance tensors are recomputed in the backward
(``torch.utils.checkpoint``), so only the (B, pixels) running log-sum is kept
per chunk instead of gigabytes of intermediates.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

DEFAULT_SIGMA = 1e-6  # in NDC-squared units (pytorch3d BlendParams sigma)


def project_to_ndc(verts_cam: torch.Tensor, K: torch.Tensor, imsize) -> torch.Tensor:
    """Camera-space verts -> (x, y) in a square NDC where the image spans
    ~[-1, 1] on the longer side (pytorch3d screen convention scale), plus z.
    verts_cam: (B, V, 3); K: (3, 3)."""
    H, W = imsize
    z = torch.clamp(verts_cam[..., 2:3], min=1e-6)
    u = verts_cam[..., 0:1] * K[0, 0] / z[..., 0:1] + K[0, 2]
    v = verts_cam[..., 1:2] * K[1, 1] / z[..., 0:1] + K[1, 2]
    s = 2.0 / max(H, W)
    x = u * s - W * s / 2.0
    y = v * s - H * s / 2.0
    return torch.cat([x, y, verts_cam[..., 2:3]], dim=-1)


def _edge_dist2(p, a, b):
    """Squared distance point->segment in 2D, broadcast."""
    ab = b - a
    t = torch.sum((p - a) * ab, -1) / torch.clamp(torch.sum(ab * ab, -1), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d = p - proj
    return torch.sum(d * d, -1)


def _signed_tri_dist2(px, v0, v1, v2):
    """px: (..., 2); v0/1/2: (..., 2). Returns signed squared distance:
    negative inside the triangle, positive outside."""
    d2 = torch.minimum(
        torch.minimum(_edge_dist2(px, v0, v1), _edge_dist2(px, v1, v2)),
        _edge_dist2(px, v2, v0),
    )

    def cross(o, a, b):
        return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
            a[..., 1] - o[..., 1]
        ) * (b[..., 0] - o[..., 0])

    c0 = cross(v0, v1, px)
    c1 = cross(v1, v2, px)
    c2 = cross(v2, v0, px)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | (
        (c0 <= 0) & (c1 <= 0) & (c2 <= 0)
    )
    return torch.where(inside, -d2, d2)


def _chunk_log_coverage(log_acc, ndc, px, fidx, vmask, sigma):
    """One face chunk: ``log_acc`` plus the chunk's sum of log(1 - d)."""
    tri = ndc[:, fidx]  # (B, C, 3, 3)
    v0, v1, v2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    behind = (v0[..., 2] <= 1e-6) | (v1[..., 2] <= 1e-6) | (v2[..., 2] <= 1e-6)
    # (B, HW, C)
    sd2 = _signed_tri_dist2(
        px[None, :, None, :],
        v0[:, None, :, :2], v1[:, None, :, :2], v2[:, None, :, :2],
    )
    d = torch.sigmoid(-sd2 / sigma)
    d = torch.where(behind[:, None, :] | (vmask[None, None, :] < 0.5), 0.0, d)
    return log_acc + torch.sum(torch.log1p(-torch.clamp(d, max=1.0 - 1e-7)), dim=-1)


def render_silhouette(
    verts_cam: torch.Tensor,  # (B, V, 3) camera-space vertices
    faces,  # (F, 3) int
    K: torch.Tensor,  # (3, 3)
    imsize: tuple[int, int],
    sigma: float = DEFAULT_SIGMA,
    face_chunk: int = 64,
) -> torch.Tensor:
    """(B, H, W) soft coverage in [0, 1], on ``verts_cam``'s device and in its
    dtype."""
    H, W = imsize
    B = verts_cam.shape[0]
    dev, dt = verts_cam.device, verts_cam.dtype
    ndc = project_to_ndc(verts_cam, K.to(dt), imsize)  # (B, V, 3)

    # pixel centers in the same NDC
    s = 2.0 / max(H, W)
    xs = (torch.arange(W, device=dev, dtype=dt) + 0.5) * s - W * s / 2.0
    ys = (torch.arange(H, device=dev, dtype=dt) + 0.5) * s - H * s / 2.0
    px = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1).reshape(-1, 2)  # (HW, 2)

    faces = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    F = faces.shape[0]
    pad = (-F) % face_chunk
    faces_chunks = torch.cat(
        [faces, torch.zeros((pad, 3), dtype=faces.dtype, device=dev)], dim=0
    ).reshape(-1, face_chunk, 3)
    valid = torch.cat(
        [torch.ones((F,), device=dev), torch.zeros((pad,), device=dev)], dim=0
    ).reshape(-1, face_chunk)
    sigma = torch.tensor(sigma, dtype=dt, device=dev)

    log_acc = torch.zeros((B, px.shape[0]), dtype=dt, device=dev)
    recompute = torch.is_grad_enabled() and ndc.requires_grad
    for fidx, vmask in zip(faces_chunks, valid):
        if recompute:
            # the (B, HW, chunk) tensors are made again in the backward
            log_acc = checkpoint(_chunk_log_coverage, log_acc, ndc, px, fidx, vmask, sigma,
                                 use_reentrant=False)
        else:
            log_acc = _chunk_log_coverage(log_acc, ndc, px, fidx, vmask, sigma)
    alpha = 1.0 - torch.exp(log_acc)
    return alpha.reshape(B, H, W)
