"""NeRF++ background: inverse-sphere points + frame-coded radiance
(a frozen copy of the port's hold_tpu_torch/render/background.py)."""

from __future__ import annotations

import torch

from .specs import MAX_CLASS

from .density import abs_density
from .mlp import (
    apply_implicit_net,
    apply_rendering_net,
    implicit_net_shapes,
    rendering_net_shapes,
    resolve_weight_norm,
)
from .transforms import safe_norm

BG_SPECS = {"pose_dim": 45, "embedding": "fourier"}


def background_plans(opt_model) -> dict:
    return {
        "implicit": implicit_net_shapes(opt_model["bg_implicit_network"], BG_SPECS),
        "rendering": rendering_net_shapes(opt_model["bg_rendering_network"], BG_SPECS),
    }


def depth2pts_outside(ray_o, ray_d, depth, radius: float):
    """ray_o/ray_d (R,S,3), inverse depth (R,S) -> (R,S,4): unit point on
    or beyond the sphere + inverse depth."""
    o_dot_d = torch.sum(ray_d * ray_o, dim=-1)
    under = o_dot_d ** 2 - (torch.sum(ray_o ** 2, -1) - radius ** 2)
    d_sphere = torch.sqrt(torch.clamp(under, min=1e-10)) - o_dot_d
    p_sphere = ray_o + d_sphere[..., None] * ray_d
    p_mid = ray_o - o_dot_d[..., None] * ray_d
    p_mid_norm = safe_norm(p_mid)

    rot_axis = torch.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / torch.clamp(safe_norm(rot_axis, keepdim=True), min=1e-12)
    phi = torch.asin(torch.clamp(p_mid_norm / radius, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    ang = (phi - theta)[..., None]
    p_new = (
        p_sphere * torch.cos(ang)
        + torch.cross(rot_axis, p_sphere, dim=-1) * torch.sin(ang)
        + rot_axis * torch.sum(rot_axis * p_sphere, -1, keepdim=True) * (1.0 - torch.cos(ang))
    )
    p_new = p_new / torch.clamp(safe_norm(p_new, keepdim=True), min=1e-12)
    return torch.cat([p_new, depth[..., None]], dim=-1)


def bg_volume_weights(z_vals_bg, bg_density):
    """Transmittance weights along the flipped (1 -> 0) inverse-depth axis."""
    R = z_vals_bg.shape[0]
    dists = torch.cat(
        [z_vals_bg[:, :-1] - z_vals_bg[:, 1:],
         torch.full((R, 1), 1e10, device=z_vals_bg.device)], dim=-1,
    )
    free_energy = dists * bg_density
    shifted = torch.cat([torch.zeros((R, 1), device=z_vals_bg.device), free_energy[:, :-1]], -1)
    return (1.0 - torch.exp(-free_energy)) * torch.exp(-torch.cumsum(shifted, dim=-1))


def background_forward(params, plans, bg_weights, ray_dirs, cam_loc, z_vals_bg,
                       frame_idx, radius: float, step=None) -> dict:
    """bg_weights (R,) leftover fg transmittance; z_vals_bg (R,S) ascending
    inverse depths; frame_idx (R,)."""
    R, S = z_vals_bg.shape
    imp = resolve_weight_norm(params["implicit"])
    rend = resolve_weight_norm(params["rendering"])
    latent = params["frame_latent"][frame_idx]

    z_flip = torch.flip(z_vals_bg, dims=[-1])
    dirs = ray_dirs[:, None, :].expand(R, S, 3)
    locs = cam_loc[:, None, :].expand(R, S, 3)
    pts4 = depth2pts_outside(locs, dirs, z_flip, radius)
    latent_pp = latent[:, None, :].expand(R, S, latent.shape[-1]).reshape(R * S, -1)

    out = apply_implicit_net(imp, plans["implicit"], pts4.reshape(R * S, 4), latent_pp,
                             step=step)
    bg_sdf = out[:, :1].float()
    rgb = apply_rendering_net(
        rend, plans["rendering"], None, None, dirs.reshape(R * S, 3), None,
        out[:, 1:], frame_latent_code=latent_pp, step=step,
    ).reshape(R, S, 3)

    w = bg_volume_weights(z_flip, abs_density(bg_sdf).reshape(R, S))
    bg_rgb_only = torch.sum(w[..., None] * rgb, dim=1)
    bg_sem = torch.zeros((R, MAX_CLASS), device=bg_weights.device)
    bg_sem[:, 0] = 1.0
    return {
        "bg_rgb": bg_weights[:, None] * bg_rgb_only,
        "bg_rgb_only": bg_rgb_only,
        "bg_semantics": bg_weights[:, None] * bg_sem,
    }
