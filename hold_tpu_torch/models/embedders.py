"""Positional encodings: NeRF Fourier + BARF coarse-to-fine window
(counterpart of hold_tpu/models/embedders.py).

embed(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)];
the BARF window is a function of the global step (a Python int here) that
weights each frequency's sin/cos block.
"""

from __future__ import annotations

import math

import torch


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


def barf_embed(x: torch.Tensor, num_freq: int, alpha: float | None,
               include_input: bool = True) -> torch.Tensor:
    enc = fourier_embed(x, num_freq, include_input=include_input)
    if alpha is None:
        return enc
    D = x.shape[-1]
    w_blocks = torch.repeat_interleave(barf_weights(alpha, num_freq), 2 * D)
    if include_input:
        w_blocks = torch.cat([torch.ones(D), w_blocks])
    return enc * w_blocks.to(device=x.device, dtype=x.dtype)


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
