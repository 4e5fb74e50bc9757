"""Fused training shade (counterpart of hold_tpu/ops/fused_shade.py).

The grad stage's default shade: per canonical point x_c with its inverse
skinning Jacobian J^-1, the embedding, the 8x256 softplus100 trunk, the SDF
and feature heads, the normal from the reverse pass through the scalar head,
and the 'pose'-mode colour MLP, as one ``torch.autograd.Function`` whose
forward and backward are CUDA kernels (``csrc/fused_shade.cu``).  The forward
keeps nothing but its inputs; the backward recomputes the forward and applies
the full second-order chain (loss -> rgb -> normal -> dSDF/dx_c -> the
trunk's Hessian), with the weight gradients summed over the points.

The numbers are the TPU kernel's (``_shade_tile``), the render's
(``ops/fused_render.py``) but for the normal's denominator,
max(sqrt(|n|^2 + 1e-12), 1e-6), which keeps the backward finite at n = 0.
``shade_train_plain`` is the forward in plain, differentiable PyTorch;
``shade_train_bwd_plain`` is the backward written out step by step, in the
order and with the bf16 roundings of the CUDA kernel: its plain version.

``fused_shade_train`` has the JAX name and outputs (sdf (B, N), rgb (B, N, 3),
normal (B, N, 3)) and is differentiable in x_c, J^-1, the frame bias and
every pack buffer, not in the window.  Given CPU tensors it runs the two
plain functions; given CUDA tensors it launches the kernels or raises, and
never falls back.  The kernels take every product's weights as one stream of
shared-memory stage images (``ops/weight_pack.py`` ``tile_shade_bwd``), made
from the packs once a call of the op: the forward reads its first
``N_FWD_SLABS`` stages (the render's stream, ``tile_shade_fwd``), the
backward all of them; the weights' gradients come back in the packs'
layout.  Each launch adds one to
``LAUNCHES[name]``: the forward once a call, the backward once a chunk of
``CHUNK`` points.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fused_render import RENDER_MACS, check_render, check_stream, shade_plain, shade_scratch
from .weight_pack import (
    C0A,
    C_TOTAL,
    CB_TOTAL,
    COLOR_LAYOUT,
    EMB_PAD,
    F_TOTAL,
    H,
    SLAB,
    T_TOTAL,
    TRANSPOSED_LAYOUT,
    TRUNK_LAYOUT,
    W_TOTAL,
    packs_of,
    tile_shade_bwd,
    tile_shade_fwd,
    window_multires,
)
from ..models.embedders import fourier_embed
from ..models.mlp import softplus100

# the multiply-adds a point the functions need (no pads), for the bound: the
# forward is the render's shade; the backward recomputes it, then takes one
# data-gradient product and one weight-gradient product of the same size for
# each forward product
SHADE_FWD_MACS = RENDER_MACS
SHADE_BWD_MACS = 3 * RENDER_MACS
# points a chunk of the backward: its workspace holds ~39 KB a point
CHUNK = 32768
BWD_ROWS = 128  # points a CTA of the backward kernel (csrc/cta_gemm.cuh TILE_M)
WGRAD_STEP = 64  # points a pipeline stage of the weight-gradient kernel
SUM_RUNS = 8  # runs of a chunk's CTAs whose partials fused_shade_bwd_kernel_sums adds in turn

LAUNCHES = {"fused_shade_train.fwd": 0, "fused_shade_train.bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def shade_train_plain(xc, jinv9, fb0, window, tw, bw, cw):
    """Forward: xc (B, N, 3), jinv9 (B, N, 9) row-major, fb0 (B, 256), the
    three packs -> (sdf (B, N), rgb (B, N, 3), normal (B, N, 3)),
    differentiable in every tensor but the window."""
    return shade_plain(xc, jinv9, window, tw, bw, cw, fb0, eps=1e-12)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emb_columns(window: torch.Tensor, x: torch.Tensor) -> tuple:
    """Per embedding column: coordinate, frequency, the forward derivative's
    factor (1, cos, -sin of the argument) and that factor's derivative."""
    L = window_multires(window)
    dev = x.device
    dims = torch.tensor([0, 1, 2] + [0, 1, 2] * (2 * L), device=dev)
    freq = torch.tensor([1.0] * 3 + [2.0 ** k for k in range(L) for _ in range(6)], device=dev)
    kind = torch.tensor([0] * 3 + [1, 1, 1, 2, 2, 2] * L, device=dev)
    arg = x[:, dims] * freq
    one, zero = torch.ones_like(arg), torch.zeros_like(arg)
    fac = torch.where(kind == 1, torch.cos(arg), torch.where(kind == 2, -torch.sin(arg), one))
    dfac = torch.where(kind == 1, -freq * torch.sin(arg),
                       torch.where(kind == 2, -freq * torch.cos(arg), zero))
    return dims, freq, fac, dfac


@torch.no_grad()
def shade_train_bwd_plain(xc, jinv9, fb0, window, tw, bw, cw, g_sdf, g_rgb, g_nrm) -> dict:
    """The backward of ``shade_train_plain``, step by step as the CUDA kernel
    takes it, given the cotangents of sdf, rgb and normal.  Returns the
    gradients of x_c, J^-1 and the frame bias, and of the five pack buffers
    (f32): ``tw_b``, ``tw_f``, ``bw_b``, ``cw_b``, ``cw_f``."""
    B, N = xc.shape[:2]
    R = B * N
    x = xc.reshape(R, 3).float()
    J = jinv9.reshape(R, 9).float()
    gs = g_sdf.reshape(R).float()
    gr = g_rgb.reshape(R, 3).float()
    gn = g_nrm.reshape(R, 3).float()
    frame = torch.arange(R, device=x.device) // N
    E = window.shape[0]
    W = {k: tw[k].float() for k, _, _ in TRUNK_LAYOUT}
    WT = {k: bw[k].float() for k, _, _ in TRANSPOSED_LAYOUT}
    C = {k: cw[k].float() for k, _, _ in COLOR_LAYOUT}
    bias, head_w, cb = tw["bias"], tw["head_w"], cw["cbias"]

    # 1. recompute: trunk (s_l, h_l in bf16), feature head, reverse pass
    emb = fourier_embed(x, window_multires(window)) * window
    e16 = _bf(torch.nn.functional.pad(emb, (0, EMB_PAD - E)))
    S, S32, Hh = [], [], []
    h = e16
    for l in range(8):
        a = h @ W[f"W{l}" if l != 4 else "W4h"].T + bias[l]
        if l == 4:
            a = a + e16 @ W["W4e"].T
        S32.append(torch.sigmoid(100.0 * a))
        S.append(_bf(S32[-1]))
        sp = softplus100(a)
        if l == 7:
            hw = gs[:, None] * sp  # the head row's gradient, first part
        h = _bf(sp)
        Hh.append(h)
    feat = _bf(Hh[7] @ WT["feat_w"].T + cb[0])
    D, U = [None] * 8, [None] * 7
    D[7] = _bf(head_w * S[7])
    for l in range(7, 0, -1):
        if l == 4:
            demb = D[4] @ WT["W4eT"].T
        u = D[l] @ WT[f"W{l}T" if l != 4 else "W4hT"].T
        U[l - 1] = _bf(u)
        D[l - 1] = _bf(u * S[l - 1])
    demb = demb + D[0] @ WT["W0T"].T
    dims, freq, fac, dfac = _emb_columns(window, x)
    g = torch.zeros_like(x).index_add_(1, dims, freq * ((demb[:, :E] * fac) * window))
    n = torch.stack([sum(g[:, i] * J[:, 3 * i + j] for i in range(3)) for j in range(3)], -1)
    den = torch.clamp(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12), min=1e-6)
    nrm = n / den
    inp = _bf(torch.cat([x, nrm, torch.zeros_like(x[:, :1]).expand(-1, C0A - 6)], -1))
    hc = [_bf(torch.relu(inp @ C["C0a"].T + feat @ C["C0f"].T + fb0.float()[frame]))]
    for l in (1, 2, 3):
        hc.append(_bf(torch.relu(hc[-1] @ C[f"C{l}"].T + cb[l])))
    rgb = torch.sigmoid((hc[3] @ C["C4"].T)[:, :3] + cb[4, :3])

    # 2. colour MLP backward
    o = torch.zeros((R, 8), device=x.device)
    o[:, :3] = _bf(gr * rgb * (1.0 - rgb))
    dl = [None] * 4
    dl[3] = _bf(torch.where(hc[3] > 0, o @ C["C4"], 0.0))
    for l in (3, 2, 1):
        dl[l - 1] = _bf(torch.where(hc[l - 1] > 0, dl[l] @ C[f"C{l}"], 0.0))
    ib = _bf(dl[0] @ C["C0a"])  # [x_c | normal | 0] columns
    fbar = _bf(dl[0] @ C["C0f"])

    # 3. the normalisation's adjoint, dJ^-1 = g (x) n_bar, g_bar = J^-1 n_bar
    nbr = gn + ib[:, 3:6]
    nb = (nbr - nrm * torch.sum(nrm * nbr, -1, keepdim=True)) / den
    djinv = (g[:, :, None] * nb[:, None, :]).reshape(R, 9)
    gb = torch.stack([sum(J[:, 3 * i + j] * nb[:, j] for j in range(3)) for i in range(3)], -1)
    xb = ib[:, 0:3].clone()

    # 4. g_bar -> d_emb_bar; the trig factors' derivative to x_c
    demb_bar = _bf(torch.nn.functional.pad(gb[:, dims] * freq * fac * window, (0, EMB_PAD - E)))
    xb.index_add_(1, dims, gb[:, dims] * freq * window * demb[:, :E] * dfac)

    # 5. up the reverse chain: s_bar = d_bar u, u_bar = d_bar s
    AP, Ub = [None] * 8, [None] * 7

    def up(l, dbar):
        s = S32[l]
        dbar = _bf(dbar)
        Ub[l] = _bf(dbar * S[l])
        AP[l] = _bf(dbar * U[l]) * 100.0 * s * (1.0 - s)

    up(0, demb_bar @ W["W0"].T)
    for l in range(1, 7):
        if l == 4:
            up(4, Ub[3] @ W["W4h"].T + demb_bar @ W["W4e"].T)
        else:
            up(l, Ub[l - 1] @ W[f"W{l}"].T)
    d7 = _bf(Ub[6] @ W["W7"].T)
    AP[7] = _bf(d7 * head_w) * 100.0 * S32[7] * (1.0 - S32[7])
    hw = hw + d7 * S[7]

    # 6, 7. down the trunk: a_bar = h_bar s + (s_bar term)
    AB, A32 = [None] * 8, [None] * 8
    A32[7] = (_bf(fbar @ WT["feat_w"]) + gs[:, None] * head_w) * S32[7] + AP[7]
    AB[7] = _bf(A32[7])
    for l in range(7, 0, -1):
        if l == 4:
            eb = AB[4] @ WT["W4eT"].T
        hbar = AB[l] @ WT[f"W{l}T" if l != 4 else "W4hT"].T
        A32[l - 1] = _bf(hbar) * S32[l - 1] + AP[l - 1]
        AB[l - 1] = _bf(A32[l - 1])
    eb = _bf(eb + AB[0] @ WT["W0T"].T)
    xb.index_add_(1, dims, eb[:, :E] * window * freq * fac)

    # weight gradients: sums over the points of outer products
    dW = {"W0": AB[0].T @ e16, "W4h": AB[4].T @ Hh[3], "W4e": AB[4].T @ e16}
    for l in (1, 2, 3, 5, 6, 7):
        dW[f"W{l}"] = AB[l].T @ Hh[l - 1]
    dWT = {"W0T": demb_bar.T @ D[0], "W4hT": Ub[3].T @ D[4], "W4eT": demb_bar.T @ D[4],
           "feat_w": fbar.T @ Hh[7]}
    for l in (1, 2, 3, 5, 6, 7):
        dWT[f"W{l}T"] = Ub[l - 1].T @ D[l]
    dC = {"C0a": dl[0].T @ inp, "C0f": dl[0].T @ feat, "C4": o.T @ hc[3]}
    for l in (1, 2, 3):
        dC[f"C{l}"] = dl[l].T @ hc[l - 1]
    dcb = torch.zeros((5, H), device=x.device)
    dcb[0] = fbar.sum(0)
    for l in (1, 2, 3):
        dcb[l] = dl[l].sum(0)
    dcb[4, :8] = o.sum(0)

    def flat(mats, layout):
        return torch.cat([mats[k].reshape(-1) for k, _, _ in layout])

    return {
        "xc": xb.reshape(B, N, 3),
        "jinv9": djinv.reshape(B, N, 9),
        "fb0": torch.zeros((B, H), device=x.device).index_add_(0, frame, dl[0]),
        "tw_b": flat(dW, TRUNK_LAYOUT),
        "tw_f": torch.cat([torch.stack(A32).sum(1).reshape(-1), hw.sum(0), gs.sum()[None]]),
        "bw_b": flat(dWT, TRANSPOSED_LAYOUT),
        "cw_b": flat(dC, COLOR_LAYOUT),
        "cw_f": dcb.reshape(-1),
    }


# --------------------------------------------------------------------------
# CUDA launches (csrc/fused_shade.cu)
# --------------------------------------------------------------------------

def _check_inputs(xc, jinv9, fb0, window, tw, bw, cw) -> int:
    B, N = xc.shape[:2]
    _cuda.check(xc, "xc", (B, N, 3))
    _cuda.check(jinv9, "jinv9", (B, N, 9))
    return check_render(window, tw, bw, cw, fb0, B)


def shade_train_fwd_cuda(xc, jinv9, fb0, window, tw, bw, cw, slabs=None) -> tuple:
    """The forward kernel: (sdf, rgb, normal).  ``slabs`` is a weight stream
    that begins with the forward's (``tile_shade_bwd``'s or
    ``tile_shade_fwd``'s), made here when not given."""
    B, N = xc.shape[:2]
    multires = _check_inputs(xc, jinv9, fb0, window, tw, bw, cw)
    dev = xc.device
    if slabs is None:
        slabs = tile_shade_fwd(tw, bw, cw)
    check_stream(slabs)
    outs = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                 for s in ((B, N), (B, N, 3), (B, N, 3)))
    scratch, ctas = shade_scratch(B * N, dev)
    _cuda.launch("hold_fused_shade_fwd",
                 *_cuda.ptrs(xc, jinv9, fb0, window, slabs, tw["f32"], cw["f32"], scratch, *outs),
                 B, N, multires, ctas)
    LAUNCHES["fused_shade_train.fwd"] += 1
    return outs


def bwd_chunks(total: int) -> tuple:
    """The backward's split of ``total`` flattened points: the workspace's
    rows (whole CTAs of ``BWD_ROWS`` points) and, per chunk, (first point,
    points, the blocks of ~2048 points each weight-gradient sum over them is
    split into)."""
    cap = -(-min(total, CHUNK) // BWD_ROWS) * BWD_ROWS
    chunks = []
    for c0 in range(0, total, cap):
        rows = min(cap, total - c0)
        chunks.append((c0, rows, max(1, min(32, rows // 2048))))
    return cap, chunks


def frame_slots(B: int, N: int) -> int:
    """Frames that the points of one backward CTA can touch: the frame-bias
    slots of its partial row."""
    return min(B, (BWD_ROWS - 1) // N + 2)


def sum_runs(n: int) -> list:
    """``fused_shade_bwd_kernel_sums``' split of ``n`` CTAs (a chunk's, or
    those that hold a frame's points): ``SUM_RUNS`` runs [a, b) of ceil(n /
    SUM_RUNS), each summed in CTA order, then the runs in order."""
    per = -(-n // SUM_RUNS)
    return [(min(n, r * per), min(n, (r + 1) * per)) for r in range(SUM_RUNS)]


def shade_train_bwd_cuda(xc, jinv9, fb0, window, tw, bw, cw, g_sdf, g_rgb, g_nrm,
                         slabs=None) -> dict:
    """The backward kernels, chunk by chunk of the flattened (B, N) points:
    the gradients as ``shade_train_bwd_plain`` returns them.  ``slabs`` is
    ``tile_shade_bwd``'s stream, made here when not given."""
    B, N = xc.shape[:2]
    multires = _check_inputs(xc, jinv9, fb0, window, tw, bw, cw)
    _cuda.check(g_sdf, "g_sdf", (B, N))
    _cuda.check(g_rgb, "g_rgb", (B, N, 3))
    _cuda.check(g_nrm, "g_nrm", (B, N, 3))
    dev = xc.device
    lib = _cuda.lib()
    if slabs is None:
        slabs = tile_shade_bwd(tw, bw, cw)
    if slabs.numel() != lib.hold_fused_shade_bwd_slabs() * SLAB:
        raise RuntimeError("the backward's weight stream differs from the kernel's")
    cap, chunks = bwd_chunks(B * N)
    kmax = frame_slots(B, N)
    wsb = torch.empty(cap * lib.hold_fused_shade_ws_cols(0), dtype=torch.bfloat16, device=dev)
    wsf = torch.empty(cap * lib.hold_fused_shade_ws_cols(1), dtype=torch.float32, device=dev)
    part = torch.empty(cap // BWD_ROWS * lib.hold_fused_shade_part_cols(kmax),
                       dtype=torch.float32, device=dev)
    grads = {"xc": torch.empty((B, N, 3), device=dev), "jinv9": torch.empty((B, N, 9), device=dev),
             "fb0": torch.zeros((B, H), device=dev), "tw_b": torch.zeros(W_TOTAL, device=dev),
             "tw_f": torch.zeros(F_TOTAL, device=dev), "bw_b": torch.zeros(T_TOTAL, device=dev),
             "cw_b": torch.zeros(C_TOTAL, device=dev), "cw_f": torch.zeros(CB_TOTAL, device=dev)}
    for c0, rows, splits in chunks:
        _cuda.launch("hold_fused_shade_bwd",
                     *_cuda.ptrs(xc, jinv9, fb0, window, g_sdf, g_rgb, g_nrm, tw["f32"], cw["f32"],
                           slabs, wsb, wsf, grads["xc"], grads["jinv9"], grads["tw_b"],
                           grads["tw_f"], grads["bw_b"], grads["cw_b"], grads["cw_f"],
                           grads["fb0"], part),
                     B * N, N, c0, rows, cap, multires, splits, kmax)
        LAUNCHES["fused_shade_train.bwd"] += 1
    return grads


# --------------------------------------------------------------------------
# The op
# --------------------------------------------------------------------------

class _FusedShadeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, jinv9, fb0, window, tw_b, tw_f, bw_b, cw_b, cw_f):
        ctx.save_for_backward(xc, jinv9, fb0, window, tw_b, tw_f, bw_b, cw_b, cw_f)
        tw, bw, cw = packs_of(tw_b, tw_f, bw_b, cw_b, cw_f)
        ctx.slabs = None
        if xc.is_cuda:
            # one weight stream a call: the forward reads its first stages,
            # the backward all of them
            ctx.slabs = tile_shade_bwd(tw, bw, cw)
            return shade_train_fwd_cuda(xc, jinv9, fb0, window, tw, bw, cw, ctx.slabs)
        _cuda.require_cpu(xc)
        return shade_train_plain(xc, jinv9, fb0, window, tw, bw, cw)

    @staticmethod
    def backward(ctx, g_sdf, g_rgb, g_nrm):
        xc, jinv9, fb0, window, *bufs = ctx.saved_tensors
        B, N = xc.shape[:2]
        cts = [torch.zeros(s, dtype=torch.float32, device=xc.device) if g is None
               else g.float().contiguous()
               for g, s in ((g_sdf, (B, N)), (g_rgb, (B, N, 3)), (g_nrm, (B, N, 3)))]
        tw, bw, cw = packs_of(*bufs)
        if xc.is_cuda:
            gr = shade_train_bwd_cuda(xc, jinv9, fb0, window, tw, bw, cw, *cts, ctx.slabs)
        else:
            _cuda.require_cpu(xc)
            gr = shade_train_bwd_plain(xc, jinv9, fb0, window, tw, bw, cw, *cts)
        packs = [gr[k].to(t.dtype) for k, t in zip(("tw_b", "tw_f", "bw_b", "cw_b", "cw_f"), bufs)]
        return (gr["xc"].to(xc.dtype), gr["jinv9"].to(jinv9.dtype), gr["fb0"].to(fb0.dtype), None,
                *packs)


def fused_shade_train(xc, jinv9, fb0, window, tw, bw, cw):
    """Training shade: canonical points (B, N, 3), J^-1 (B, N, 9) row-major,
    the frame bias (B, 256), the embedding window (E,) and the packs of
    ``pack_trunk_weights`` / ``pack_trunk_transposed`` /
    ``pack_color_weights`` (built under grad mode for parameter
    gradients) -> (sdf (B, N), rgb (B, N, 3), normal (B, N, 3))."""
    return _FusedShadeTrain.apply(xc.contiguous(), jinv9.contiguous(), fb0.contiguous(),
                                  window, tw["bf16"], tw["f32"], bw["bf16"], cw["bf16"],
                                  cw["f32"])
