"""Positional encodings: NeRF Fourier + BARF coarse-to-fine window
(counterpart of hold_tpu/models/embedders.py).

embed(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)];
the BARF window is a function of the global step (a Python int here) that
weights each frequency's sin/cos block.
"""

from __future__ import annotations

import math

import torch

from ..utils.device_constants import cached, device_of, to_device


def embed_dim(input_dims: int, num_freq: int, include_input: bool = True) -> int:
    return input_dims * (2 * num_freq + (1 if include_input else 0))


def fourier_embed(x: torch.Tensor, num_freq: int, include_input: bool = True) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(num_freq, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., L, D)
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)
    enc = enc.reshape(x.shape[:-1] + (num_freq * 2 * x.shape[-1],))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def barf_alpha(step: int, num_freq: int, start: int, end: int) -> float:
    """alpha(step) in [0, L]: zero for `start` steps, then linear to L."""
    denom = max(end - start - 1, 1)
    it = min(max(step - start, 0), denom)
    return num_freq * float(it) / denom


def barf_weights(alpha: float, num_freq: int) -> torch.Tensor:
    """Per-frequency window weights (L,), cosine-eased in the active band."""
    w = []
    for k in range(num_freq):
        ak = alpha - k
        c = min(max(ak, 0.0), 1.0)
        w.append((1.0 - math.cos(c * math.pi)) / 2.0 if 0.0 <= ak < 1.0 else c)
    return torch.tensor(w, dtype=torch.float32)


def barf_window(alpha: float, num_freq: int, input_dims: int = 3) -> torch.Tensor:
    """Per-column weights of the embedding with its input: ones for x, then
    each frequency's window weight over its 2 * input_dims sin/cos columns."""
    return torch.cat([torch.ones(input_dims),
                      torch.repeat_interleave(barf_weights(alpha, num_freq), 2 * input_dims)])


def window_on(alpha: float | None, num_freq: int, input_dims: int, device,
              dtype=torch.float32, include_input: bool = True) -> torch.Tensor:
    """``barf_window(alpha, num_freq, input_dims)`` (ones where ``alpha`` is
    None), without its first ``input_dims`` columns unless
    ``include_input``, as ``dtype`` on ``device``: computed on the host as
    ever, sent without a stream sync and kept per arguments
    (``utils/device_constants.py``), so that every use of one step's window
    shares one copy."""
    dev = device_of(device)

    def make():
        if alpha is None:
            win = torch.ones(embed_dim(input_dims, num_freq))
        else:
            win = barf_window(alpha, num_freq, input_dims)
        if not include_input:
            win = win[input_dims:]
        return to_device(win.to(dtype), dev)

    return cached(("window", alpha, num_freq, input_dims, include_input, dtype, dev), make)


def embed_window(plan: dict, step, barf_cfg, device=None) -> torch.Tensor:
    """The fused kernels' (E,) f32 embedding window for an implicit-net plan:
    ones, or the BARF window at ``step`` for a ``barf`` node (the JAX
    package's ``_fused_embed_plan`` column 3); kept on ``device`` per window
    (``window_on``): no stream sync."""
    L = plan["multires"]
    alpha = None
    if plan["embedding"] == "barf" and step is not None:
        alpha = barf_alpha(step, L, *barf_cfg)
    return window_on(alpha, L, 3, device)


def barf_embed(x: torch.Tensor, num_freq: int, alpha: float | None,
               include_input: bool = True) -> torch.Tensor:
    enc = fourier_embed(x, num_freq, include_input=include_input)
    if alpha is None:
        return enc
    return enc * window_on(alpha, num_freq, x.shape[-1], x.device, x.dtype, include_input)


def make_embedder(mode: str, num_freq: int, barf_s: int = 0, barf_e: int = 1):
    """embed_fn(x, step_or_none); step=None disables BARF annealing."""
    if mode == "fourier":
        def fn(x, step=None):
            return fourier_embed(x, num_freq)
        return fn
    if mode == "barf":
        def fn(x, step=None):
            alpha = None if step is None else barf_alpha(step, num_freq, barf_s, barf_e)
            return barf_embed(x, num_freq, alpha)
        return fn
    raise ValueError(f"unknown embedder mode {mode}")
