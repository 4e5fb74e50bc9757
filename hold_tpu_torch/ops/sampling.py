"""Point sampling around meshes and vertex sets for the loss targets
(counterpart of hold_tpu/ops/sampling.py).

Each function takes its random draws as tensors, so a caller can feed the
same numbers to this package and to the JAX one; ``draw_*`` helpers make
them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..utils.device_constants import constant

# empirical canonical-hand box half-extents for the uniform samples
HAND_GLOBAL_SIGMA_XYZ = (0.15, 0.06, 0.12)


def point_in_space_sample(pc_input: torch.Tensor, local_sigma: float, global_sigma_xyz,
                          noise: torch.Tensor, glob_u: torch.Tensor) -> torch.Tensor:
    """One gaussian-jittered sample per center + uniform box samples.

    pc_input (B,N,3); noise (B,N,3) standard normal; glob_u (B,G,3) in [0,1)
    with G = int(N * global_ratio).  -> (B, N + G, 3)."""
    local = pc_input + noise * local_sigma
    if torch.is_tensor(global_sigma_xyz):
        g = global_sigma_xyz.to(dtype=pc_input.dtype, device=pc_input.device)
    else:
        g = constant(global_sigma_xyz, pc_input.dtype, pc_input.device)
    glob = glob_u * (2.0 * g) - g
    return torch.cat([local, glob], dim=1)


def draw_point_in_space(gen, B: int, N: int, global_ratio: float, device):
    """(noise (B,N,3), glob_u (B,int(N*ratio),3)) for point_in_space_sample."""
    noise = torch.randn((B, N, 3), generator=gen, device=device)
    glob_u = torch.rand((B, int(N * global_ratio), 3), generator=gen, device=device)
    return noise, glob_u


def sample_on_mesh_barycentric(verts: torch.Tensor, faces: torch.Tensor,
                               fidx: torch.Tensor, u: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """Barycentric surface samples: verts (B,V,3), faces (F,3), face picks
    fidx (B,S), u and v (B,S,1) in [0,1) -> (B,S,3)."""
    tri = faces[fidx]  # (B,S,3)
    corners = [
        torch.gather(verts, 1, tri[..., i:i + 1].expand(-1, -1, 3)) for i in range(3)
    ]
    flip = (u + v) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    return u * corners[0] + v * corners[1] + (1.0 - u - v) * corners[2]


def draw_barycentric(gen, B: int, S: int, num_faces: int, device):
    """(fidx (B,S), u (B,S,1), v (B,S,1)) for sample_on_mesh_barycentric."""
    fidx = torch.randint(0, num_faces, (B, S), generator=gen, device=device)
    u = torch.rand((B, S, 1), generator=gen, device=device)
    v = torch.rand((B, S, 1), generator=gen, device=device)
    return fidx, u, v
