"""The render cell: the window drives the port's ``render_frame`` over the
sequence's frames in turn, on one device, as ``render_cli.render_frames``
calls it (its chunks through ``make_chunk_renderer``, its maps copied to
the host as numpy arrays).

Set-up builds the scene and the parameters (from the seed, on the card)
and renders two frames, which warm up every shape.  The window counts the
rays of the chunks it completes: a chunk is not started once the window's
seconds are up, and the frame it belongs to is dropped.  After the window a
sample of each completed frame's pixels, drawn from the seed (half on the
hand and the object, half anywhere), is rendered by the plain reference and
every map is compared there.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import compare, counts, device, weights
from ..reference import mlp as ref_mlp
from ..reference import model as ref_model
from ..trace import Traced, span
from .train import inputs


class _WindowClosed(Exception):
    pass


class Program:
    def __init__(self, cell: dict, cfg: dict, inp: dict, seed: int, dev):
        from hold_tpu_torch.data.dataset import SequenceData
        from hold_tpu_torch.models.holdnet import build_scene
        from hold_tpu_torch.render.renderer import make_chunk_renderer
        from hold_tpu_torch.utils.config import Cfg

        seq = inp["seq"]
        tr = cfg["train"]
        self.data = SequenceData(seq["images"], seq["masks"], seq["data"])
        self.scene = build_scene(inp["opt_model"], Cfg(barf_s=tr["barf_s"], barf_e=tr["barf_e"]),
                                 self.data.scene_data(), dev)
        self.base = weights.make_params(inp["opt_model"], seq["data"]["entities"],
                                        self.data.n_frames, seed, dev)
        self.params = self.base
        self.chunk_fn = make_chunk_renderer(self.scene)
        self.ppb = int(cell["pixel_per_batch"])
        self.down = int(cell["render_downsample"])

    def render(self, idx: int, chunk_fn=None) -> dict:
        from hold_tpu_torch.render.renderer import render_frame

        fb = self.data.full_frame_batch(idx, downsample=self.down)
        with span("frame"):
            return render_frame(self.params, self.scene, fb, pixel_per_batch=self.ppb,
                                chunk_fn=chunk_fn or self.chunk_fn)


def pixel_sample(data, idx: int, down: int, n: int, rng: np.random.RandomState) -> np.ndarray:
    """Flat pixel indices of one frame at the render's stride: half drawn
    from the hand's and the object's pixels (ground-truth mask), half from
    the whole frame, without repeats."""
    mask = data.masks[idx][::down, ::down].reshape(-1)
    fg = np.nonzero(mask > 0)[0]
    a = rng.choice(fg, size=min(n // 2, fg.size), replace=False)
    rest = np.setdiff1d(np.arange(mask.size), a)
    b = rng.choice(rest, size=n - a.size, replace=False)
    return np.sort(np.concatenate([a, b]))


def reference_maps(cfg: dict, inp: dict, base: dict, frames: list, dev,
                   control: bool = False) -> list:
    """The plain reference's maps at each ``(frame batch, pixels)`` of
    ``frames`` (float32, TF32 off; ``control``: its bf16 products in float8
    and the rest in TF32)."""
    tr = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    scene = ref_model.build_scene(inp["opt_model"], inp["seq"]["data"]["entities"],
                                  (tr["barf_s"], tr["barf_e"]), dev)
    out = []
    with ref_mlp.rounding(ref_mlp.round_fp8 if control else None):
        for fb, pix in frames:
            batch = {
                "frame_idx": torch.as_tensor(np.asarray(fb["frame_idx"]), dtype=torch.long,
                                             device=dev),
                "scene_scale": torch.as_tensor(float(fb["scene_scale"]), device=dev),
                "intrinsics": torch.as_tensor(np.asarray(fb["intrinsics"]), dtype=torch.float32,
                                              device=dev),
                "extrinsics": torch.as_tensor(np.asarray(fb["extrinsics"]), dtype=torch.float32,
                                              device=dev),
                "uv": torch.as_tensor(fb["uv"][:, pix], dtype=torch.float32, device=dev),
            }
            res = ref_model.render_chunk(base, scene, batch)
            out.append({k: v.cpu().numpy() for k, v in res.items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out


def flat(maps: dict, pix: np.ndarray) -> dict:
    """A frame's maps at flat pixel indices, one row a pixel."""
    out = {}
    for k, v in maps.items():
        v = np.asarray(v)
        out[k] = (v.reshape(v.shape[0] * v.shape[1], -1) if v.ndim == 3 else v.reshape(-1))[pix]
    return out


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    inp = inputs(cell, cfg)
    prog = Program(cell, cfg, inp, seed, dev)
    n_frames = prog.data.n_frames
    for idx in range(int(cell["warmup_frames"])):
        prog.render(idx)
    device.sync(dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = device.peak(dev)
    device.reset_peak(dev)

    result = {"setup_s": setup_s}
    done, chunks, rays = [], 0, 0
    idx = int(cell["warmup_frames"])
    if trace:
        def spanned(*a, **k):
            with span("chunk"):
                return prog.chunk_fn(*a, **k)

        with Traced() as tr:
            for _ in range(int(cell["trace_frames"])):
                done.append((idx % n_frames, prog.render(idx % n_frames, spanned)))
                idx += 1
        fb = prog.data.full_frame_batch(0, downsample=prog.down)
        frame_rays = fb["uv"].shape[1]
        result["trace"] = {"summary": tr.summary, "frames": len(done),
                           "frame_flops": counts.cell_flops(cfg["model"], "render", frame_rays,
                                                            len(prog.scene.node_ids)),
                           "shade_points": len(prog.scene.node_ids) * frame_rays
                           * (cfg["model"]["ray_sampler"]["N_samples"] + 2
                              + cfg["model"]["ray_sampler"]["N_samples_extra"])}
        attempted = len(done)
    else:
        start = time.perf_counter()

        def counted(params, batch, packs=None):
            nonlocal chunks, rays
            if time.perf_counter() - start >= seconds:
                raise _WindowClosed
            out = prog.chunk_fn(params, batch, packs)
            chunks += 1
            rays += batch["uv"].shape[1]
            return out

        try:
            while True:
                done.append((idx % n_frames, prog.render(idx % n_frames, counted)))
                idx += 1
        except _WindowClosed:
            pass
        device.sync(dev)
        elapsed = time.perf_counter() - start
        result["render_rays_per_s"] = rays / elapsed
        attempted = chunks
    peak = device.peak(dev)
    result["peak_gib"] = peak / 2 ** 30
    result["memory_peak_bytes"] = max(peak, setup_peak)
    result["attempted"] = attempted

    rng = np.random.RandomState((int(seed) + 2) % 2 ** 32)
    compared, prog_maps = [], {}
    for fidx, maps in done:
        pix = pixel_sample(prog.data, fidx, prog.down, int(cell["compare_pixels"]), rng)
        compared.append((prog.data.full_frame_batch(fidx, downsample=prog.down), pix))
        for k, v in flat(maps, pix).items():
            prog_maps.setdefault(k, []).append(v)
    base = prog.base
    del prog, done
    gc.collect()
    device.empty_cache(dev)

    ref = reference_maps(cfg, inp, base, compared, dev)
    ref_maps = {k: np.concatenate([r[k] for r in ref]) for k in ref[0]}
    got = {k: np.concatenate(v) for k, v in prog_maps.items()}
    gap, worst = compare.map_gap(got, ref_maps)
    result["values"] = {"maps": gap}
    result["worst"] = {"maps": worst, "frames": len(compared)}
    return result
