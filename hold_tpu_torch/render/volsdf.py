"""VolSDF rendering math: camera rays, sphere intersections, factor merging,
transmittance weights (counterpart of hold_tpu/render/volsdf.py)."""

from __future__ import annotations

import torch

from ..utils.transforms import safe_norm


def density2weight(density: torch.Tensor, z_vals: torch.Tensor, z_max: torch.Tensor):
    """Foreground weights (R, S) and leftover transmittance (R,), with the
    explicit last interval to z_max."""
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], z_max[:, None] - z_vals[:, -1:]], dim=-1)
    free_energy = dists * density
    alpha = 1.0 - torch.exp(-free_energy)
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]), free_energy], dim=-1)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance[:, :-1], transmittance[:, -1]


def integrate(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * weights[:, :, None], dim=1)


def merge_factors(factors_list: list[dict], num_nodes: int | None = None) -> dict:
    """Merge per-node factors by depth (stable sort, so equal depths keep node
    order), then drop the duplicated near/far book-ends, keeping the
    reference's [num_nodes-1 : -num_nodes] slice and z_max."""
    if num_nodes is None:
        num_nodes = len(factors_list)
    z_cat = torch.cat([f["z_vals"] for f in factors_list], dim=1)
    z_sorted, perm = torch.sort(z_cat, dim=1, stable=True)
    out = {}
    for k in factors_list[0]:
        if k == "z_vals":
            continue
        cat = torch.cat([f[k] for f in factors_list], dim=1)
        out[k] = torch.gather(cat, 1, perm[:, :, None].expand(-1, -1, cat.shape[-1]))
    if num_nodes > 1:
        sl = slice(num_nodes - 1, -num_nodes)
        out = {k: v[:, sl] for k, v in out.items()}
        out["z_vals"] = z_sorted[:, sl]
        out["z_max"] = z_sorted[:, -num_nodes]
    else:
        out["z_vals"] = z_sorted
        out["z_max"] = z_sorted[:, -1]
    return out


def volumetric_render(factors: dict, vis: bool = False) -> dict:
    """Density -> weights -> integrated rgb, mask, normal, depth and
    semantics; ``vis`` (rendering) adds ``fg_rgb_vis``, the foreground over a
    white background."""
    fg_weights, bg_weights = density2weight(
        factors["density"][..., 0], factors["z_vals"], factors["z_max"]
    )
    out = {
        "fg_rgb": integrate(factors["color"], fg_weights),
        "fg_weights": fg_weights,
        "mask_prob": torch.clamp(
            integrate(torch.ones_like(factors["color"][:, :, :1]), fg_weights), 0.0, 1.0
        ),
        "normal": integrate(factors["normal"], fg_weights),
        "depth": integrate(factors["z_vals"][:, :, None], fg_weights),
        "fg_semantics": integrate(factors["semantics"], fg_weights),
        "bg_weights": bg_weights,
    }
    if vis:
        out["fg_rgb_vis"] = out["fg_rgb"] + bg_weights[:, None]
    return out


def get_camera_rays(uv: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor):
    """uv (B,P,2) pixel coords, extrinsics (B,4,4) cam-to-world, intrinsics
    (B,4,4) -> (unit ray dirs (B,P,3), cam_loc (B,3))."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    x, y = uv[:, :, 0], uv[:, :, 1]
    z = torch.ones_like(x)
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    pts_cam = torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)
    world = torch.einsum("bij,bpj->bpi", extrinsics, pts_cam)[..., :3]
    cam_loc = extrinsics[:, :3, 3]
    dirs = world - cam_loc[:, None, :]
    dirs = dirs / torch.clamp(safe_norm(dirs, keepdim=True), min=1e-12)
    return dirs, cam_loc


def get_sphere_intersections(cam_loc: torch.Tensor, ray_dirs: torch.Tensor, r: float = 1.0):
    """Near/far ray-sphere distances (R, 2), discriminant clamped, >= 0."""
    d_dot_o = torch.sum(ray_dirs * cam_loc, dim=-1, keepdim=True)
    under = d_dot_o ** 2 - (torch.sum(cam_loc * cam_loc, -1, keepdim=True) - r ** 2)
    s = torch.sqrt(torch.clamp(under, min=1e-10))
    return torch.clamp(torch.cat([-s, s], dim=-1) - d_dot_o, min=0.0)
