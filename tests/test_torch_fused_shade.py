"""hold_tpu_torch's fused training shade (ops/fused_shade.py) against the JAX
package.

At the kernel's full width (implicit net 8x256, rendering net 4x256), B = 2
frames of N = 256 points, inputs made with numpy from a seed.  The JAX side
is ``_shade_tile`` under ``jax.vmap``, differentiated with ``jax.grad``: the
plain reference that tests/test_fused_shade.py holds the interpret-mode
kernel to.  Checked:

- the differentiable packs equal the packs bit for bit, and their
  gradients reach the params;
- ``shade_train_plain`` against JAX at JAX's forward bounds (the sdf's
  allowing for bf16 rounding flips, see ``test_forward_matches_jax``);
- ``shade_train_bwd_plain`` (the CUDA kernel's plain version) against torch
  autograd of ``shade_train_plain``, for every input and pack buffer;
- ``fused_shade_train`` on CPU tensors against ``jax.grad`` of the same loss
  as tests/test_fused_shade.py, on x_c, J^-1, the frame bias and every param
  behind the packs, at rtol 5e-3 and atol 5e-3 max|ref|;
- a padded N (131) equals its prefix; the MAC counts of the bound; the
  frame-bias gradient's rounding noise, which chip_smoke.py reads on the
  card too;
- the backward's column-sum plan: each CTA's frame pieces, the runs of
  CTAs, and their fixed-order plain mirrors against torch.sum;
- the kernels' weight streams: the backward's layout, and the forward's as
  its first 82 stages, un-swizzled back to the packs;
- the slice: one grad step of a full-width toy scene with the fused shade
  against the JAX package's under HOLD_FUSED_TRAIN=interpret, at JAX's own
  fused-vs-chunked bounds; and that ``--no_fused_train`` and the render's
  ``--no_fused_render`` never run the fused shade.

The CUDA kernels are held against the plain versions on the card (marked
``gpu``; skipped without one), the backward in
tests/test_torch_fused_shade_cuda.py, which imports no JAX.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.models import holdnet as jhn
from hold_tpu.models import losses as jloss
from hold_tpu.models import nodes as jnodes
from hold_tpu.ops import fused_query as jfq
from hold_tpu.ops import fused_render as jfr
from hold_tpu.ops import fused_shade as jfs
from hold_tpu.ops import knn as jknn
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models import nodes as tnodes
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.ops import fused_query as tfq
from hold_tpu_torch.ops import fused_render as tfr
from hold_tpu_torch.ops import fused_shade as fs
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax
from test_torch_fused_render import _nets
from test_torch_train_step import _draws_from_jax_keys

B, N = 2, 256
BUFS = ("tw_b", "tw_f", "bw_b", "cw_b", "cw_f")
# JAX's bound between its kernel and its XLA twin (tests/test_fused_shade.py)
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-3


def _leaves(tree: dict) -> dict:
    return {"layers": [{k: v.detach().clone().requires_grad_(True) for k, v in l.items()}
                       for l in tree["layers"]]}


def _packs(timp, trend, iplan, grad=True):
    # with grad, the transposed pack is built from the params (as the nodes
    # do), so that the gradients of both packs add up in f32; without, under
    # no_grad and from the forward pack (as the render does)
    with torch.set_grad_enabled(grad):
        tw = tfq.pack_trunk_weights(timp, iplan)
        return tw, tfr.pack_trunk_transposed(timp, iplan, None if grad else tw), \
            tfr.pack_color_weights(trend, timp)


@contextlib.contextmanager
def _f64_products():
    """Every product ``a @ b`` of a float32 ``a`` summed in float64."""
    matmul = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda x, y: (matmul(x.double(), y.double()).float()
                                            if x.dtype == torch.float32 else matmul(x, y))
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def _buffers(tw, bw, cw):
    return (tw["bf16"], tw["f32"], bw["bf16"], cw["bf16"], cw["f32"])


def _jax_shade(xc, jinv9, fb0, plan, tw, bw, cw):
    """The JAX tile math over frames (tests/test_fused_shade.py _reference)."""
    def per_frame(x, j, f):
        sdf, rgb, nrm = jfs._shade_tile(x.T, j.T, f[:, None], plan, tw, bw, cw)
        return sdf[0], rgb.T, nrm.T

    return jax.vmap(per_frame)(xc, jinv9, fb0)


def _loss(sdf, rgb, nrm, xp):
    return xp.sum(sdf ** 2) + xp.sum(rgb * rgb) + xp.sum(xp.abs(nrm[..., 0]))


@pytest.fixture(scope="module")
def case():
    iplan, _, (jimp, jrend), (timp, trend) = _nets("hand", 0)
    rng = np.random.RandomState(1)
    xc = (rng.randn(B, N, 3) * 0.1).astype(np.float32)
    jinv = (np.eye(3).reshape(9) + rng.randn(B, N, 9) * 0.05).astype(np.float32)
    fb0 = (rng.randn(B, 256) * 0.1).astype(np.float32)
    plan = jfq.embed_plan(iplan["multires"], None)

    def jref(xc, jinv, fb0, imp, rend):
        return _jax_shade(xc, jinv, fb0, plan, jfq.pack_trunk_weights(imp, iplan),
                          jfr.pack_trunk_transposed(imp, iplan), jfr.pack_color_weights(rend, imp))

    # eagerly: XLA:CPU refuses jitted bf16 x bf16 -> f32 products
    jout = jax.device_get(jref(xc, jinv, fb0, jimp, jrend))
    jgrad = jax.device_get(jax.grad(lambda *a: _loss(*jref(*a), jnp), argnums=(0, 1, 2, 3, 4))(
        xc, jinv, fb0, jimp, jrend))
    return {"iplan": iplan, "timp": timp, "trend": trend, "xc": xc, "jinv": jinv, "fb0": fb0,
            "jout": jout, "jgrad": jgrad, "window": tfq.embed_window(iplan, None, (0, 1))}


@pytest.mark.parametrize("kind", ["hand", "object"])
def test_differentiable_packs_equal_the_packs_and_reach_the_params(kind):
    iplan, _, _, (timp, trend) = _nets(kind, 2)
    ref = _buffers(*_packs(timp, trend, iplan, grad=False))
    limp, lrend = _leaves(timp), _leaves(trend)
    got = _buffers(*_packs(limp, lrend, iplan))
    rng = np.random.RandomState(3)
    weights = []
    for g, r in zip(got, ref):
        assert g.requires_grad and not r.requires_grad
        assert g.dtype == r.dtype and torch.equal(g.detach(), r)
        weights.append(torch.tensor(rng.randn(g.numel()).astype(np.float32)).to(g.dtype))
    sum((g.float() * w.float()).sum() for g, w in zip(got, weights)).backward()
    # layer 1 sits in the forward pack as W1 and in the transposed one as W1T
    off = 256 * 48
    w1 = weights[0][off:off + 256 * 256].float().view(256, 256)
    w1t = weights[2][off:off + 256 * 256].float().view(256, 256)
    assert torch.equal(limp["layers"][1]["w"].grad, w1 + w1t.T)
    for l, layer in enumerate(limp["layers"]):
        for k in ("w", "b"):
            assert torch.isfinite(layer[k].grad).all() and layer[k].grad.abs().max() > 0, (l, k)
    for l, layer in enumerate(lrend["layers"]):
        assert layer["w"].grad.abs().max() > 0, l
        # layer 0's bias enters through the frame bias, not the packs
        assert (layer["b"].grad is None) == (l == 0), l


def test_forward_matches_jax(case):
    tw, bw, cw = _packs(case["timp"], case["trend"], case["iplan"], grad=False)
    got = fs.shade_train_plain(*(torch.tensor(case[k]) for k in ("xc", "jinv", "fb0")),
                               case["window"], tw, bw, cw)
    (gs, gr, gn), (rs, rr, rn) = (t.detach().numpy() for t in got), case["jout"]
    np.testing.assert_allclose(gr, rr, rtol=1e-4, atol=1e-4)
    # JAX's 1e-4 holds its kernel to its own XLA twin, which sums in the
    # same order; here a hidden activation's bf16 rounding flips now and
    # then where the two frameworks' f32 sums differ in order (2 of 512
    # points beyond, at 2.4e-4)
    d = np.abs(gs - rs)
    beyond = d > 1e-4 + 1e-4 * np.abs(rs)
    assert beyond.mean() <= 0.01 and d.max() <= 5e-4, (beyond.sum(), d.max())
    np.testing.assert_allclose(gn, rn, rtol=5e-2, atol=5e-3)
    assert np.mean(np.abs(gn - rn)) < 1e-4


def _inputs(case, n=N):
    return [torch.tensor(case[k][:, :n]).requires_grad_(True) for k in ("xc", "jinv")] + [
        torch.tensor(case["fb0"]).requires_grad_(True)]


def test_explicit_backward_matches_autograd(case):
    tw, bw, cw = _packs(case["timp"], case["trend"], case["iplan"], grad=False)
    bufs = [b.detach().clone().requires_grad_(True) for b in _buffers(tw, bw, cw)]
    views = fs._unpack(*bufs)
    ins = _inputs(case)
    out = fs.shade_train_plain(*ins, case["window"], *views)
    # the cotangents of test_gradients_match_jax's loss
    cts = torch.autograd.grad(_loss(*out, torch), out, retain_graph=True)
    ref = torch.autograd.grad(_loss(*out, torch), ins + bufs)
    got = fs.shade_train_bwd_plain(*(t.detach() for t in ins), case["window"],
                                   *fs._unpack(*(b.detach() for b in bufs)), *cts)
    for name, r in zip(("xc", "jinv9", "fb0") + BUFS, ref):
        r = r.float().numpy()
        g = got[name].reshape(r.shape).numpy()
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(r).max(),
                                   err_msg=name)


def test_gradients_match_jax(case):
    limp, lrend = _leaves(case["timp"]), _leaves(case["trend"])
    ins = _inputs(case)
    fs.reset_launch_counts()
    out = fs.fused_shade_train(*ins, case["window"], *_packs(limp, lrend, case["iplan"]))
    _loss(*out, torch).backward()
    assert not any(fs.LAUNCHES.values())  # CPU tensors: the plain versions ran
    jg = case["jgrad"]
    got = [t.grad for t in ins]
    refs = list(jg[:3])
    names = ["xc", "jinv9", "fb0"]
    for tag, tree, jtree in (("implicit", limp, jg[3]), ("rendering", lrend, jg[4])):
        jtree = params_from_jax(jtree)
        for i, (layer, jlayer) in enumerate(zip(tree["layers"], jtree["layers"])):
            for k in layer:
                g = layer[k].grad
                got.append(torch.zeros_like(layer[k]) if g is None else g)
                refs.append(jlayer[k].detach().numpy())
                names.append(f"{tag}/{i}/{k}")
    for name, g, r in zip(names, got, refs):
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(g.detach().numpy().astype(np.float64), r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(np.abs(r).max(), 1e-8), err_msg=name)


def test_padding_is_inert(case):
    """N = 131 gives its prefix's outputs and gradients."""
    packs = _packs(case["timp"], case["trend"], case["iplan"], grad=False)
    results = []
    for n in (131, N):
        ins = _inputs(case, n)
        sdf, rgb, nrm = fs.fused_shade_train(*ins, case["window"], *packs)
        loss = (sdf[:, :131].sum() + rgb[:, :131].sum() + nrm[:, :131].sum())
        loss.backward()
        results.append((float(loss.detach()), ins[0].grad[:, :131], ins[1].grad[:, :131], ins[2].grad))
    (l1, *g1), (l2, *g2) = results
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_mac_counts():
    assert fs.SHADE_FWD_MACS == tfr.RENDER_MACS == 1_247_744
    assert fs.SHADE_BWD_MACS == 3 * 1_247_744 == 3_743_232
    # the bound at the slice's shape (125,440 points a node), bf16 tensor
    # cores at 989 TFLOP/s
    assert round(2 * fs.SHADE_FWD_MACS * 125_440 / 989e12 * 1e3, 4) == 0.3165
    assert round(2 * fs.SHADE_BWD_MACS * 125_440 / 989e12 * 1e3, 4) == 0.9495
    # the backward's weight stream: 38 products of 256 x 256 in four stages each, 12 narrow ones
    assert fs.N_BWD_SLABS == 38 * 4 + 12 == 164


@pytest.mark.parametrize("total", [1, 127, 129, 12_483 * 3, 125_440, 32_768 + 1, 65_536])
def test_bwd_chunks_cover_every_point_once(total):
    """Whole CTAs of the backward's 128-point tile in the workspace; the chunks
    tile [0, total) with no gap and no overlap whatever ``total`` is."""
    cap, chunks = fs.bwd_chunks(total)
    assert cap % fs.BWD_ROWS == 0 and fs.BWD_ROWS == 128
    assert cap <= -(-fs.CHUNK // fs.BWD_ROWS) * fs.BWD_ROWS
    seen = np.zeros(total, np.int64)
    for c0, rows, splits in chunks:
        assert 0 < rows <= cap and splits >= 1
        seen[c0:c0 + rows] += 1
        # the sums' blocks cover the chunk's rows, wgrad's in whole pipeline steps
        per = -(-(-(-rows // splits)) // fs.WGRAD_STEP) * fs.WGRAD_STEP
        assert per * splits >= rows
    assert (seen == 1).all()


def _frame_pieces(c0: int, rows: int, N: int) -> list:
    """Per CTA of the chunk of points c0 .. c0 + rows - 1, the (frame, first
    point, end point) pieces that its frame-bias slots sum, in row order: its
    points cut at every frame boundary that falls inside it."""
    out = []
    for p0 in range(c0, c0 + rows, fs.BWD_ROWS):
        p1, pieces, p = min(p0 + fs.BWD_ROWS, c0 + rows), [], p0
        while p < p1:
            end = min(p1, (p // N + 1) * N)
            pieces.append((p // N, p, end))
            p = end
        out.append(pieces)
    return out


def _butterfly_order(rows16: torch.Tensor) -> torch.Tensor:
    """A warp's 16 rows (16, C) summed per column as the rows kernel's
    shuffles do: rows g and g + 8 in the lane, then lane bits 4, 3, 2; the
    column's owner lane is 2 (c % 32 // 8) + c % 2."""
    s = rows16[:8] + rows16[8:]  # lane g's pair sums
    lanes = torch.arange(8)
    owner = (torch.arange(s.shape[1]) % 32 // 8) * 2 + torch.arange(s.shape[1]) % 2
    w = s + s[lanes ^ 4]
    x = w + w[lanes ^ 2]
    y = x + x[lanes ^ 1]
    return y.gather(0, owner[None])[0]


@torch.no_grad()
def _column_sums_fixed_order(vals: torch.Tensor, from_tile: bool) -> torch.Tensor:
    """The backward's column sums of f32 rows ``vals`` (R, C) over every
    point, in the kernels' order, chunk by chunk: per CTA the warps'
    butterflies then the warps in order (the a_bar and head rows), or the 128
    rows in order (``from_tile``: the colour deltas); then ``fs.sum_runs`` over
    the chunk's CTAs: the order the kernels are written to add in."""
    R, C = vals.shape
    out = torch.zeros(C, dtype=torch.float32)
    for c0, rows, _ in fs.bwd_chunks(R)[1]:
        parts = []
        for p0 in range(c0, c0 + rows, fs.BWD_ROWS):
            tile = torch.zeros((fs.BWD_ROWS, C), dtype=torch.float32)
            tile[:min(fs.BWD_ROWS, c0 + rows - p0)] = vals[p0:p0 + fs.BWD_ROWS].float()
            acc = torch.zeros(C, dtype=torch.float32)
            if from_tile:
                for r in range(fs.BWD_ROWS):
                    acc = acc + tile[r]
            else:
                for w in range(fs.BWD_ROWS // 16):
                    acc = acc + _butterfly_order(tile[16 * w:16 * w + 16])
            parts.append(acc)
        tot = torch.zeros(C, dtype=torch.float32)
        for a, b in fs.sum_runs(len(parts)):
            run = torch.zeros(C, dtype=torch.float32)
            for j in range(a, b):
                run = run + parts[j]
            tot = tot + run
        out = out + tot
    return out


@torch.no_grad()
def _frame_sums_fixed_order(vals: torch.Tensor, N: int) -> torch.Tensor:
    """The frame bias's sums of ``vals`` (R, C) per frame of N points, in the
    kernels' order: each CTA's pieces (``_frame_pieces``) in row order, then
    ``fs.sum_runs`` over the chunk's CTAs that hold the frame, added chunk by
    chunk."""
    R, C = vals.shape
    out = torch.zeros((-(-R // N), C), dtype=torch.float32)
    for c0, rows, _ in fs.bwd_chunks(R)[1]:
        slots = {}
        for j, pieces in enumerate(_frame_pieces(c0, rows, N)):
            for f, a, b in pieces:
                acc = torch.zeros(C, dtype=torch.float32)
                for p in range(a, b):
                    acc = acc + vals[p].float()
                slots.setdefault(f, []).append(acc)
        for f, parts in slots.items():
            tot = torch.zeros(C, dtype=torch.float32)
            for a, b in fs.sum_runs(len(parts)):
                run = torch.zeros(C, dtype=torch.float32)
                for j in range(a, b):
                    run = run + parts[j]
                tot = tot + run
            out[f] = out[f] + tot
    return out


@pytest.mark.parametrize("b,n", [(3, 200), (2, 129), (5, 40), (2, 20_000)])
def test_bias_sum_plan(b, n):
    """The backward's column sums as the kernels take them: each CTA's frame
    pieces cover its points once, cut exactly at the frame boundaries inside
    it, within ``frame_slots`` slots; ``sum_runs`` covers a chunk's CTAs in
    order; the plain fixed-order mirrors (the warps' butterflies, the tile's
    rows, the frames' pieces) equal torch.sum over the same rows.  (3, 200)
    has CTAs straddling both frame boundaries, (5, 40) CTAs over four frames,
    (2, 20,000) two chunks."""
    total = b * n
    _, chunks = fs.bwd_chunks(total)
    seen = np.zeros(total, np.int64)
    straddle = 0
    for c0, rows, _ in chunks:
        plan = _frame_pieces(c0, rows, n)
        assert len(plan) == -(-rows // fs.BWD_ROWS)
        for j, pieces in enumerate(plan):
            p0 = c0 + j * fs.BWD_ROWS
            assert pieces[0][1] == p0 and pieces[-1][2] == min(p0 + fs.BWD_ROWS, c0 + rows)
            assert 1 <= len(pieces) <= fs.frame_slots(b, n)
            straddle += len(pieces) > 1
            for (f, a, e), nxt in zip(pieces, pieces[1:] + [None]):
                assert a < e and a // n == f and (e - 1) // n == f
                seen[a:e] += 1
                if nxt is not None:
                    assert e == nxt[1] and e % n == 0 and nxt[0] == f + 1
        runs = fs.sum_runs(len(plan))
        assert len(runs) == fs.SUM_RUNS and runs[0][0] == 0 and runs[-1][1] == len(plan)
        assert all(a <= e and e == a2 for (a, e), (a2, _) in zip(runs, runs[1:]))
    assert (seen == 1).all()
    if n % fs.BWD_ROWS:
        assert straddle > 0
    rng = np.random.RandomState(n)
    vals = torch.tensor(rng.randn(total, 256).astype(np.float32))
    want = vals.double().sum(0)
    for from_tile in (False, True):
        got = _column_sums_fixed_order(vals, from_tile)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=2e-4)
    got = _frame_sums_fixed_order(vals, n)
    want = vals.double().view(b, n, 256).sum(1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=2e-4)


def test_backward_weight_stream_layout(case):
    """``tile_shade_bwd``: 164 stages of 32 KB in the order the backward kernel
    consumes them; its first 30 are the fused query's layout of the trunk; a
    spot element of a full, a 16-column and a narrow matrix sits where
    ``csrc/cta_gemm.cuh`` documents; nothing of it carries a gradient."""
    tw, bw, cw = _packs(case["timp"], case["trend"], case["iplan"], grad=True)
    stream = fs.tile_shade_bwd(tw, bw, cw)
    assert stream.dtype == torch.bfloat16 and not stream.requires_grad
    assert stream.shape == (fs.N_BWD_SLABS * tfq.SLAB,) and fs.N_BWD_SLABS == 164
    raw = stream.view(torch.int16)
    assert torch.equal(raw[:30 * tfq.SLAB], tfq.tile_for_kernel(tw).detach().view(torch.int16))

    def first_stage(entry):
        at = 0
        for e in fs.BWD_STREAM:
            if e == entry:
                return at
            at += fs._stages(e)
        raise KeyError(entry)

    def bits(t):
        return t.detach().contiguous().view(torch.int16)

    def in_slab(n, k):  # the value's place in its slab: rows of 64, 16-byte groups swizzled
        return n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8

    # a (256, 256) matrix: stage = first + k / 64, rows of 128 bytes, swizzled
    n, k = 201, 150
    assert raw[(first_stage("W6T") + k // 64) * tfq.SLAB + in_slab(n, k)] == bits(bw["W6T"])[n, k]
    # the colour net's 16-column layer 0 segment: one stage, columns 16.. zero
    n, k = 77, 5
    st = first_stage("C0a") * tfq.SLAB
    assert raw[st + in_slab(n, k)] == bits(cw["C0a"])[n, k]
    assert not stream[st:st + tfq.SLAB].view(256, 8, 8)[
        (torch.arange(8)[None, :] ^ (torch.arange(256)[:, None] % 8)) >= 2].any()
    # a narrow (48, 256) matrix: its four k-slabs of 48 rows in one stage
    n, k = 40, 200
    st = first_stage(("W4eT", 48)) * tfq.SLAB
    assert raw[st + (k // 64) * 48 * 64 + in_slab(n, k)] == bits(bw["W4eT"])[n, k]
    # the transposes made here: C2T[n][k] = C2[k][n]
    n, k = 9, 130
    assert raw[(first_stage("C2T") + k // 64) * tfq.SLAB + in_slab(n, k)] == bits(cw["C2"])[k, n]


def _unswizzle(image: torch.Tensor, n: int, k: int, narrow: bool) -> torch.Tensor:
    """A weight-stream entry's stages -> its (n, k) matrix: the inverse of
    ``_swizzled_slabs`` (the XOR of a row's 16-byte groups with the row
    number mod 8 is its own inverse); the pad columns must be zero."""
    slabs = -(-k // 64)
    rows = n if narrow else 256
    groups = image[:slabs * rows * 64].view(slabs, rows, 8, 8)[:, :n]
    idx = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)
    out = torch.gather(groups, 2, idx[None, :, :, None].expand(slabs, n, 8, 8))
    out = out.permute(1, 0, 2, 3).reshape(n, slabs * 64)
    assert not out[:, k:].float().any()
    return out[:, :k]


def test_forward_weight_stream_is_the_backward_prefix(case):
    """``tile_shade_fwd`` (the forward kernel's and the render's weight
    stream): the first 82 stages of ``tile_shade_bwd``, bit for bit, in the
    same entries; each entry un-swizzles back to the packs' matrix."""
    tw, bw, cw = _packs(case["timp"], case["trend"], case["iplan"], grad=False)
    fwd = tfr.tile_shade_fwd(tw, bw, cw)
    bwd = fs.tile_shade_bwd(tw, bw, cw)
    assert tfr.N_FWD_SLABS == 30 + 4 + 30 + 18 == 82
    assert fwd.dtype == torch.bfloat16 and fwd.shape == (tfr.N_FWD_SLABS * tfq.SLAB,)
    assert fs.BWD_STREAM[:len(tfr.FWD_STREAM)] == tfr.FWD_STREAM
    assert torch.equal(fwd.view(torch.int16), bwd[:fwd.numel()].view(torch.int16))
    mats = tfr.stream_matrices(tw, bw, cw)
    at = 0
    for entry in tfr.FWD_STREAM:
        name, narrow = (entry, 0) if isinstance(entry, str) else entry
        m = mats[name][:narrow] if narrow else mats[name]
        stages = fs._stages(entry)
        got = _unswizzle(fwd[at * tfq.SLAB:(at + stages) * tfq.SLAB], *m.shape, bool(narrow))
        assert torch.equal(got.view(torch.int16), m.contiguous().view(torch.int16)), entry
        at += stages
    assert at == tfr.N_FWD_SLABS


def test_frame_bias_gradient_noise():
    """The plain backward against itself with its products summed in
    float64: within the JAX bound on every tensor but the frame bias's, a
    sum over each frame's points whose terms cancel under seeded cotangents
    (chip_smoke.py takes the same reading on the card, part by part, and
    holds the kernel to a multiple of it)."""
    from hold_tpu_torch.models.mlp import (
        implicit_net_shapes, init_implicit_net, init_rendering_net, resolve_weight_norm,
    )
    from hold_tpu_torch.models.specs import MANO_SPECS

    g = torch.Generator().manual_seed(0)
    oi = DEFAULT_CONFIG["model"]["implicit_network"]
    iplan = implicit_net_shapes(oi, MANO_SPECS)
    imp = resolve_weight_norm(init_implicit_net(g, oi, MANO_SPECS))
    rend = resolve_weight_norm(init_rendering_net(
        g, DEFAULT_CONFIG["model"]["rendering_network"], MANO_SPECS))
    packs = _packs(imp, rend, iplan, grad=False)
    b, n = 2, 3000
    rng = np.random.RandomState(b)
    args = [torch.tensor(a.astype(np.float32)) for a in (
        rng.randn(b, n, 3) * 0.1, np.eye(3).reshape(9) + rng.randn(b, n, 9) * 0.05,
        rng.randn(b, 256) * 0.1)]
    cts = [torch.tensor(rng.randn(*s).astype(np.float32)) for s in ((b, n), (b, n, 3), (b, n, 3))]
    window = tfq.embed_window(iplan, None, (0, 1))
    f32 = fs.shade_train_bwd_plain(*args, window, *packs, *cts)
    with _f64_products():
        f64 = fs.shade_train_bwd_plain(*args, window, *packs, *cts)
    worst = {}
    for k, r in f32.items():
        ratio = (f64[k] - r).abs() / (GRAD_RTOL * r.abs() + GRAD_ATOL * r.abs().max())
        worst[k] = float(ratio.max())
    print({k: round(v, 3) for k, v in worst.items()})
    assert all(v <= 1.0 for k, v in worst.items() if k != "fb0"), worst
    assert 1.0 < worst["fb0"] <= 10.0, worst


# --------------------------------------------------------------------------
# The slice
# --------------------------------------------------------------------------

STEP, EPOCH = 300, 25
ARGS = {"barf_s": 0, "barf_e": 1000}


def _toy_model():
    m = copy.deepcopy(DEFAULT_CONFIG["model"])
    m["proposal"]["enabled"] = False
    m["bg_implicit_network"]["dims"] = [96] * 8
    m["bg_rendering_network"]["dims"] = [32]
    m["ray_sampler"].update(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                            max_total_iters=2, beta_iters=3)
    return m


def _dot_f32(orig, lhs, rhs, *args, **kw):
    # bf16 operands widened to f32 (exact), so that XLA:CPU runs the product
    # jitted; the cotangents of the bf16 operands still round to bf16
    def wide(x):
        return x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x

    return orig(wide(lhs), wide(rhs), *args, **kw)


def _jax_fused_shade_train(xc, jinv9, fb0, plan_arr, tw, bw, cw, interpret=False):
    """The JAX fused shade's math as plain XLA (its kernels' reference)."""
    orig = jax.lax.dot_general
    jax.lax.dot_general = functools.partial(_dot_f32, orig)
    try:
        return _jax_shade(xc, jinv9, fb0, plan_arr, tw, bw, cw)
    finally:
        jax.lax.dot_general = orig


@pytest.fixture(scope="module")
def slice_step():
    """One grad stage of a full-width toy scene, JAX with its fused shade
    (HOLD_FUSED_TRAIN=interpret, the shade as plain XLA) against the port's
    default."""
    mp = pytest.MonkeyPatch()
    for name in ("knn_inverse_warp", "knn_inverse_warp_diff", "knn_jacobian_inverse"):
        mp.setattr(jnodes, name, functools.partial(getattr(jknn, name), interpret=True))
    mp.setattr(jfs, "fused_shade_train", _jax_fused_shade_train)
    mp.setenv("HOLD_FUSED_TRAIN", "interpret")
    mp.delenv("HOLD_NO_FUSED_TRAIN", raising=False)
    mp.delenv("HOLD_NO_FUSED_RENDER", raising=False)
    try:
        built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
        seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
        sd = seq.scene_data()
        model = _toy_model()
        jscene = jhn.build_scene(model, ARGS, sd)
        assert all(jnodes._use_fused_shade(p) for p in jscene.plans.values())
        jparams = jhn.init_scene_params(jax.random.PRNGKey(0), jscene, sd)
        batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
        jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        jz = jax.device_get(jax.jit(lambda p, b: jhn.sample_all_z(
            p, jscene, b, None, jnp.asarray(STEP), jnp.asarray(EPOCH)))(jparams, jbatch))
        rng = jax.random.PRNGKey(7)

        def loss_fn(p):
            out = jhn.holdnet_forward(p, jscene, jbatch, jhn.empty_object_mesh_state(), rng,
                                      jnp.asarray(STEP), jnp.asarray(EPOCH), training=True,
                                      z_vals_dict=jz)
            losses = jloss.compute_losses(jbatch, out, jscene.node_ids, jnp.asarray(STEP))
            return losses["loss"], losses

        (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    finally:
        mp.undo()
    tscene = thn.build_scene(model, ARGS, sd, "cpu")
    tparams = params_from_jax(jax.device_get(jparams))
    tbatch = batch_to_device(batch_np, "cpu")
    B_, P = batch_np["uv"].shape[:2]
    draws = _draws_from_jax_keys(rng, jscene, B_, P)
    jz_t = {k: torch.tensor(v) for k, v in jz.items()}
    return {"jl": jax.device_get(jl), "jg": jax.device_get(jg), "tscene": tscene,
            "tparams": tparams, "tbatch": tbatch, "draws": draws, "jz": jz_t, "model": model,
            "sd": sd}


def _grad_stage(st, scene, params):
    out = thn.holdnet_forward(params, scene, st["tbatch"], thn.empty_object_mesh_state("cpu"),
                              st["draws"], STEP, EPOCH, st["jz"])
    losses = compute_losses(st["tbatch"], out, scene.node_ids, STEP)
    losses["loss"].backward()
    return losses


def test_fused_grad_step_matches_jax(slice_step):
    st = slice_step
    assert all(p.fused_train for p in st["tscene"].plans.values())
    tl = _grad_stage(st, st["tscene"], st["tparams"])
    np.testing.assert_allclose(float(tl["loss"].detach()), float(st["jl"]["loss"]), rtol=2e-3)
    ref = flatten_params(params_from_jax(st["jg"]))
    got = flatten_params(st["tparams"])
    checked = 0
    for k, r in ref.items():
        if not got[k].requires_grad:  # obj_scale: fixed during scene training
            continue
        r = r.detach().numpy().astype(np.float64)
        g = np.zeros_like(r) if got[k].grad is None else got[k].grad.numpy().astype(np.float64)
        # JAX's own bound between its fused and chunked shade
        # (tests/test_fused_shade.py): 5 % and 4 % of the tensor's scale
        scale = max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(g, r, rtol=0.05, atol=0.04 * scale + 5e-5, err_msg=k)
        checked += 1
    assert checked > 100


def test_no_fused_train_and_no_fused_render_never_run_the_fused_shade(slice_step, monkeypatch):
    st = slice_step
    calls = []
    real = tnodes.fused_shade_train

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tnodes, "fused_shade_train", spy)
    chunked = thn.build_scene(st["model"], ARGS, st["sd"], "cpu", fused_train=False)
    assert not any(p.fused_train for p in chunked.plans.values())
    _grad_stage(st, chunked, params_from_jax(jax.device_get(st["jg"])))
    assert not calls
    no_render = thn.build_scene(st["model"], ARGS, st["sd"], "cpu", fused_render=False)
    assert not any(p.fused_train or p.fused_render for p in no_render.plans.values())
    with torch.no_grad():
        thn.holdnet_render(st["tparams"], no_render, st["tbatch"], st["jz"])
    assert not calls
    _grad_stage(st, st["tscene"], params_from_jax(jax.device_get(st["jg"])))
    assert len(calls) == len(st["tscene"].node_ids)
    from hold_tpu_torch.utils.config import parse_args

    assert parse_args(["--case", "toy", "--no_fused_train"])[0].no_fused_train


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused training shade's kernels are CUDA only")
    return torch.device("cuda")


def _worst(got, ref):
    """max |got - ref| over the JAX bound."""
    ref = ref.float()
    return float(((got.float() - ref).abs()
                  / (GRAD_RTOL * ref.abs() + GRAD_ATOL * ref.abs().max())).max())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3000, 131, 257])
def test_cuda_fused_shade_matches_plain(cuda, case, n):
    """Both kernels against their plain versions on the card: the forward at
    the render kernels' bounds, the backward, given the cotangents of a
    loss, within the JAX bound on every element of every returned tensor
    (the last points' rows and the SDF head's bias read on their own)."""
    rng = np.random.RandomState(n)
    b = 2
    args = [torch.tensor(a.astype(np.float32), device=cuda) for a in (
        rng.randn(b, n, 3) * 0.1, np.eye(3).reshape(9) + rng.randn(b, n, 9) * 0.05,
        rng.randn(b, 256) * 0.1)]
    packs = [{k: v.to(cuda) for k, v in p.items()}
             for p in _packs(case["timp"], case["trend"], case["iplan"], grad=False)]
    args += [case["window"].to(cuda)] + packs
    got = fs.shade_train_fwd_cuda(*args)
    torch.cuda.synchronize()
    ref = fs.shade_train_plain(*args)
    d = (got[0] - ref[0]).abs()
    assert float((d / (2e-2 * ref[0].abs().clamp(min=1.0))).max()) <= 1.0
    assert float(d.mean()) <= 4e-3
    assert float((got[1] - ref[1]).abs().max()) <= 1e-2
    dn = (got[2] - ref[2]).abs().flatten()
    assert float(dn.quantile(0.99)) <= 1e-2 and float(dn.max()) <= 0.1
    # the cotangents of test_gradients_match_jax's loss
    g_nrm = torch.zeros_like(ref[2])
    g_nrm[..., 0] = torch.sign(ref[2][..., 0])
    cts = [2.0 * ref[0], 2.0 * ref[1], g_nrm]
    gg = fs.shade_train_bwd_cuda(*args, *cts)
    torch.cuda.synchronize()
    gr = fs.shade_train_bwd_plain(*args, *cts)

    def parts(g):
        return {**g, "head_b": g["tw_f"][-1:], "xc tail": g["xc"].reshape(-1, 3)[-64:],
                "jinv9 tail": g["jinv9"].reshape(-1, 9)[-64:]}

    pk = parts(gg)
    for k, r in parts(gr).items():
        assert bool(torch.isfinite(pk[k]).all()), k
        assert _worst(pk[k], r) <= 1.0, (k, _worst(pk[k], r))
