"""Full-frame rendering: chunked inference over all pixels of a frame
(counterpart of hold_tpu/render/renderer.py).

Each chunk of pixels runs the eval sampler (``sample_all_z`` with no
generator: the deterministic grid) and then ``holdnet_render``.  Chunk
outputs stay on the device until the frame is done; one copy to the host at
the end.  Over several processes, ``parallel.sharding.split_chunk_renderer``
splits each chunk's pixels over the ranks (the training loop's validation
frames); ``render_cli`` renders on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.holdnet import holdnet_render, render_packs, sample_all_z
from ..utils.tracing import span, stage

# the maps a chunk keeps, as the JAX chunk renderer does
_KEEP = ("rgb", "instance_map", "bg_rgb_only", "normal", "depth", "mask_prob", "fg_rgb_vis")
_KEEP_NODE = ("fg_rgb_vis", "mask_prob", "normal")


def make_chunk_renderer(scene, timer=None):
    """Returns render_chunk(params, batch, packs=None) -> dict of (P, C)
    device tensors; ``packs`` is ``holdnet.render_packs(params, scene)``,
    built per chunk when not given.  Its stages are the spans
    ``hold.sampler`` and ``hold.shade`` (``utils/tracing.py``); ``timer``
    (a ``utils.tracing.StepTimer``, optional) records them as the phases
    'sampler' and 'shade', by events on the device's stream."""

    @torch.no_grad()
    def render_chunk(params, batch, packs=None):
        with stage("sampler", timer, scene.device):
            z_vals = sample_all_z(params, scene, batch, None, None, None)
        with stage("shade", timer, scene.device):
            out = holdnet_render(params, scene, batch, z_vals, packs)
            keep = {k: out[k] for k in _KEEP}
            for nid in scene.node_ids:
                keep.update({f"{nid}.{k}": out[f"{nid}.{k}"] for k in _KEEP_NODE})
        return keep

    return render_chunk


def render_frame(params, scene, frame_batch: dict, pixel_per_batch: int = 4096,
                 chunk_fn=None) -> dict[str, np.ndarray]:
    """frame_batch from ``SequenceData.full_frame_batch``; returns per-pixel
    maps as (H, W[, C]) numpy arrays.  Pass a ``chunk_fn``
    (``make_chunk_renderer``) to time the phases or reuse one across frames.
    The fused render's weight packs are built once for the frame.  The last
    chunk holds the pixels that are left (the JAX package pads it to a full
    chunk, for its compiled shapes)."""
    if chunk_fn is None:
        chunk_fn = make_chunk_renderer(scene)
    with torch.no_grad(), span("hold.packs"):
        packs = render_packs(params, scene)
    dev = scene.device
    H, W = frame_batch["img_hw"]
    uv = frame_batch["uv"]  # (1, HW, 2)
    n_pix = uv.shape[1]
    base = {
        "frame_idx": torch.as_tensor(np.asarray(frame_batch["frame_idx"]), dtype=torch.long,
                                     device=dev),
        "scene_scale": torch.as_tensor(float(frame_batch["scene_scale"]), device=dev),
    }
    for k in ("intrinsics", "extrinsics"):
        base[k] = torch.as_tensor(np.asarray(frame_batch[k]), dtype=torch.float32, device=dev)
    uv_dev = torch.as_tensor(uv, dtype=torch.float32, device=dev)
    outs: dict[str, list] = {}
    for s in range(0, uv.shape[1], pixel_per_batch):
        res = chunk_fn(params, {**base, "uv": uv_dev[:, s:s + pixel_per_batch]}, packs)
        for k, v in res.items():
            outs.setdefault(k, []).append(v)
    result = {}
    with span("hold.gather"):
        for k, chunks in outs.items():
            flat = torch.cat(chunks, dim=0).cpu().numpy()
            result[k] = flat.reshape(H, W) if flat.ndim == 1 else flat.reshape(H, W, -1)
    return result


def outputs_to_panel(res: dict, gt_rgb: np.ndarray | None = None) -> np.ndarray:
    """Side-by-side panel in [0, 1]: [gt | rgb | fg_vis | normal | instance]."""
    H, W = res["rgb"].shape[:2]
    tiles = []
    if gt_rgb is not None:
        tiles.append(np.clip(gt_rgb.reshape(H, W, 3), 0, 1))
    tiles.append(np.clip(res["rgb"], 0, 1))
    tiles.append(np.clip(res["fg_rgb_vis"], 0, 1))
    tiles.append(np.clip(res["normal"] * 0.5 + 0.5, 0, 1))
    inst = res["instance_map"].astype(np.float32)
    tiles.append(np.stack([inst == 1, inst == 2, inst == 3], axis=-1).astype(np.float32))
    return np.concatenate(tiles, axis=1)
