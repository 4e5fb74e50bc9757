"""The work a step or a frame needs, in FLOPs and bytes, and the least time
one H100 could take for it: the yardstick of the roofline and MFU metrics.

Frozen copies of the port's counts: the multiply-adds a point of the trunk,
the render shade and the training shade (``hold_tpu_torch/ops/fused_query.py``
``TRUNK_MACS``, ``ops/fused_render.py`` ``RENDER_MACS``, ``ops/fused_shade.py``
``SHADE_*_MACS``), and ``chip_smoke.py``'s ``bound`` and ``knn_needed``.  They
count what the function needs: no zero pads and no recomputation.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor cores, f32 outside them,
# HBM3 bandwidth (at the 700 W power limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

H = 256
# the 8x256 trunk and the width-1 SDF head: layer 0 takes E inputs and layer
# 3 gives 256 - E outputs, which layer 4 takes beside the E embedding
# columns, so E cancels: seven 256x256 products and the head row
TRUNK_MACS = 7 * H * H + H
# the render shade: the trunk and head, the reverse pass for the normal (the
# same seven products transposed), the feature head, the colour MLP (6 + 256
# inputs, three 256x256 layers, 3 outputs)
RENDER_MACS = TRUNK_MACS + 7 * H * H + H * H + (6 + H) * H + 3 * H * H + 3 * H
# the training shade: the forward is the render's shade; the backward takes
# one data-gradient and one weight-gradient product of the same size for each
# forward product (its recomputation of the forward is not counted)
SHADE_FWD_MACS = RENDER_MACS
SHADE_BWD_MACS = 2 * RENDER_MACS
# per-point bytes the training shade's backward must move: x_c (3) and J^-1
# (9) in, the gradients of sdf, rgb and normal (7) in, those of x_c and J^-1
# (12) out, float32
SHADE_BWD_BYTES = 4 * (3 + 9 + 7 + 12)
# the render shade: points (3) and the warp's inputs in, sdf, rgb, normal,
# distance and x_c (11) out
RENDER_BYTES = 4 * (3 + 11)


def bound_s(tc_flops: float, f32_flops: float, nbytes: float) -> tuple:
    """(seconds, what bounds them): the largest of the tensor-core operations
    at the bf16 peak, the other operations at the f32 peak and the bytes at
    the memory rate."""
    ops = max(tc_flops / PEAK_BF16, f32_flops / PEAK_F32)
    by = nbytes / PEAK_BYTES
    return max(ops, by), ("operations" if ops >= by else "bytes")


def knn_needed(n_pts: int, V: int, J: int, K: int = 15) -> float:
    """f32 operations of n_pts points' KNN blends that no exact search
    avoids: the distances of the min(K, V) vertices of a point's set, the
    exponential and J multiply-adds of each, the normalisation."""
    return n_pts * (9.0 * min(K, V) + K * (2 * J + 2) + J)


def net_dims(model: dict) -> dict:
    """Layer widths of the background's nets and the proposal net, from a
    configuration's ``model`` (embeddings as the nets take them)."""
    bg, bgr, p = (model["bg_implicit_network"], model["bg_rendering_network"],
                  model["proposal"])
    return {
        "bg": [4 * (2 * bg["multires"] + 1) + bg["dim_frame_encoding"]] + bg["dims"]
              + [bg["d_out"] + bg["feature_vector_size"]],
        "bg_render": [3 * (2 * bgr["multires_view"] + 1) + bgr["dim_frame_encoding"]
                      + bgr["feature_vector_size"]] + bgr["dims"] + [bgr["d_out"]],
        "proposal": [3 * (2 * p["multires"] + 1)] + [p["width"]] * p["depth"] + [1],
    }


def proposal_macs(dims: list) -> int:
    """Multiply-adds a point of the proposal net (39-64-64-64-1)."""
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def bg_macs(bg_dims: list, bg_render_dims: list) -> int:
    """Multiply-adds a sample of the background's nets, its implicit net and
    its colour net (the skip's inputs cancel out of the sum, as the
    trunk's do)."""
    return (sum(bg_dims[i] * bg_dims[i + 1] for i in range(len(bg_dims) - 1))
            + sum(bg_render_dims[i] * bg_render_dims[i + 1]
                  for i in range(len(bg_render_dims) - 1)))


def row7_bwd_bound_s(points: int) -> float:
    """The least time of row 7's backward over ``points`` points."""
    return bound_s(2.0 * SHADE_BWD_MACS * points, 0.0, SHADE_BWD_BYTES * points)[0]


def render_shade_bound_s(points: int) -> float:
    """The least time of rows 8-9's shade over ``points`` points."""
    return bound_s(2.0 * RENDER_MACS * points, 0.0, RENDER_BYTES * points)[0]


def train_step_flops(rays: int, nodes: int, samples: int, sampler_points: int,
                     prop_macs: int, bg_samples: int, bg_mac: int) -> float:
    """Model FLOPs of one training step: each node's shade forward and
    backward at ``samples`` points a ray, its proposal queries at
    ``sampler_points`` a ray, and the background's nets at ``bg_samples`` a
    ray, forward and backward (x3)."""
    shade = nodes * rays * samples * (SHADE_FWD_MACS + SHADE_BWD_MACS)
    sampler = nodes * rays * sampler_points * prop_macs
    bg = 3 * rays * bg_samples * bg_mac
    return 2.0 * (shade + sampler + bg)


def render_frame_flops(rays: int, nodes: int, samples: int, sampler_points: int,
                       bg_samples: int, bg_mac: int) -> float:
    """Model FLOPs of rendering ``rays`` rays: each node's trunk queries in
    the sampler, its render shade at ``samples`` points a ray, the
    background's nets."""
    return 2.0 * (nodes * rays * (sampler_points * TRUNK_MACS + samples * RENDER_MACS)
                  + rays * bg_samples * bg_mac)


def cell_flops(model: dict, kind: str, rays: int, nodes: int) -> float:
    """Model FLOPs of a training step or a rendered frame of ``rays`` rays
    under a configuration's ``model``."""
    rs, dims = model["ray_sampler"], net_dims(model)
    samples = rs["N_samples"] + 2 + rs["N_samples_extra"]
    sampler_points = rs["N_samples_eval"] * rs["max_total_iters"]
    bg = bg_macs(dims["bg"], dims["bg_render"])
    if kind == "train":
        return train_step_flops(rays, nodes, samples, sampler_points,
                                proposal_macs(dims["proposal"]),
                                rs["N_samples_inverse_sphere"], bg)
    return render_frame_flops(rays, nodes, samples, sampler_points,
                              rs["N_samples_inverse_sphere"], bg)
