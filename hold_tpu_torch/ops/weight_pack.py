"""The fused kernels' weights: the packs and their shared-memory layout.

The fused query (``ops/fused_query.py``), the render shade
(``ops/fused_render.py``) and the training shade (``ops/fused_shade.py``)
read the nets' weights from three packs, each one flat buffer with named
views:

- the trunk pack (``pack_trunk_weights``): the nine bf16 matrices of
  ``TRUNK_LAYOUT``, and the f32 biases and SDF head;
- the transposed pack (``pack_trunk_transposed``): the same matrices
  transposed for the reverse pass, and the feature head (``TRANSPOSED_LAYOUT``);
- the colour pack (``pack_color_weights``): the colour MLP's bf16 matrices
  (``COLOR_LAYOUT``) and its f32 biases.

A kernel streams its products' weights through a ring of 32 KB stages in
shared memory, in the order a CTA consumes them: a weight stream
(``TRUNK_STREAM`` for the query's trunk, ``FWD_STREAM`` for the render and
the training shade's forward, ``BWD_STREAM`` for its backward).  A stage
holds 64-column slabs of bf16 rows of 128 bytes, each row's 16-byte groups
XOR-ed with the row's number mod 8: the 128-byte swizzle ``wgmma`` reads
(``slab_offset``).  ``weight_stream`` builds a stream from the packs' flat
buffers by one gather through an index made once per stream and device:
a permutation of the packs' entries with zeros in the pads, no rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device_constants import device_of, to_device

H = 256  # trunk width
EMB_PAD = 48  # embedding columns the kernels multiply (three MMA k-steps)
C0A = 16  # colour layer-0 columns the kernels multiply for [x_c | normal | 0 ...]
SLAB_K = 64  # columns a slab: a row of 128 bytes
SLAB = H * SLAB_K  # bf16 values a stage holds (32 KB)

# the packs' matrices in their flat buffers' order: (name, rows, cols),
# row-major; the trunk's are (out, in), the transposed pack's W*T (in, out)
# and its feat_w (out, in), the colour pack's (out, in)
TRUNK_LAYOUT = (
    ("W0", H, EMB_PAD), ("W1", H, H), ("W2", H, H), ("W3", H, H), ("W4h", H, H),
    ("W4e", H, EMB_PAD), ("W5", H, H), ("W6", H, H), ("W7", H, H),
)
TRANSPOSED_LAYOUT = (
    ("W0T", EMB_PAD, H), ("W1T", H, H), ("W2T", H, H), ("W3T", H, H), ("W4hT", H, H),
    ("W4eT", EMB_PAD, H), ("W5T", H, H), ("W6T", H, H), ("W7T", H, H), ("feat_w", H, H),
)
COLOR_LAYOUT = (("C0a", H, C0A), ("C0f", H, H), ("C1", H, H), ("C2", H, H), ("C3", H, H),
                ("C4", 8, H))
W_TOTAL = sum(r * c for _, r, c in TRUNK_LAYOUT)
T_TOTAL = sum(r * c for _, r, c in TRANSPOSED_LAYOUT)
C_TOTAL = sum(r * c for _, r, c in COLOR_LAYOUT)
F_TOTAL = 8 * H + H + 1  # trunk f32: bias (8, 256) | head row (256) | head bias
CB_TOTAL = 5 * H  # colour f32: feature head | colour layers 1, 2, 3 | layer 4 (3 used)

# Weight streams.  A name alone is a (256, K) matrix cut along k into slabs
# of 64 columns, a stage each (K <= 64: one stage, zero-padded); a name with
# N is an (N, 256) matrix whose four k-slabs share one stage.  A name ending
# in T that no layout holds is the transpose of the matrix it names.
_TRUNK_UP = ("W0", "W1", "W2", "W3", "W4h", "W4e", "W5", "W6", "W7")
_TRUNK_DOWN = ("W7T", "W6T", "W5T", ("W4eT", 48), "W4hT", "W3T", "W2T", "W1T", ("W0T", 48))
# the fused query's trunk (csrc/fused_query.cu)
TRUNK_STREAM = _TRUNK_UP
# the render shade and the training shade's forward (csrc/shade_common.cuh)
FWD_STREAM = (
    *_TRUNK_UP, "feat_w",                                   # trunk, feature head
    *_TRUNK_DOWN,                                           # the reverse pass
    "C0a", "C0f", "C1", "C2", "C3", ("C4", 8),              # colour MLP
)
# the training shade's backward (csrc/fused_shade.cu): the forward's stream,
# which its recompute consumes in the same order, then the backward's own
BWD_STREAM = (
    *FWD_STREAM,                                            # 1: the recompute
    "C4T", "C3T", "C2T", "C1T", ("C0aT", 16), "C0fT",       # 2: colour MLP backward
    *_TRUNK_UP,                                             # 5: up the reverse chain
    "feat_wT", *_TRUNK_DOWN,                                # 7: down the trunk
)


def _matrices() -> dict:
    """Each layout's matrices: name -> (pack, offset, rows, cols), the packs
    in the order ``weight_stream`` takes their buffers."""
    out = {}
    for pack, layout in enumerate((TRUNK_LAYOUT, TRANSPOSED_LAYOUT, COLOR_LAYOUT)):
        off = 0
        for name, r, c in layout:
            out[name] = (pack, off, r, c)
            off += r * c
    return out


_MATRICES = _matrices()


def _entry(entry) -> tuple:
    """A stream entry -> (pack, offset, rows, cols of the stored matrix,
    transposed, narrow rows or 0)."""
    name, narrow = (entry, 0) if isinstance(entry, str) else entry
    if name in _MATRICES:
        return (*_MATRICES[name], False, narrow)
    return (*_MATRICES[name[:-1]], True, narrow)


def stages(entry) -> int:
    """Stages an entry of a weight stream takes: one for narrow rows, else
    one a 64-column slab."""
    _, _, r, c, t, narrow = _entry(entry)
    return 1 if narrow else -(-(r if t else c) // SLAB_K)


N_SLABS = sum(map(stages, TRUNK_STREAM))
N_FWD_SLABS = sum(map(stages, FWD_STREAM))
N_BWD_SLABS = sum(map(stages, BWD_STREAM))


def slab_offset(slab, n, k, rows: int = H):
    """Where element (n, k) of slab ``slab`` sits, in bf16 values from the
    start of its stream entry, for slabs of ``rows`` rows: rows of 64 values
    (128 bytes) whose 16-byte groups are XOR-ed with the row's number mod 8."""
    return slab * rows * SLAB_K + n * SLAB_K + (((k // 8) ^ (n % 8)) * 8) + k % 8


def _stream_index(entries: tuple) -> np.ndarray:
    """Per value of the stream, where it comes from in ``cat([0], packs'
    flat bf16 buffers in order)``: 0 for a pad."""
    starts = np.cumsum([1, W_TOTAL, T_TOTAL])
    index = np.zeros(sum(map(stages, entries)) * SLAB, dtype=np.int32)
    base = 0
    for entry in entries:
        pack, off, r, c, t, narrow = _entry(entry)
        N, K = (c, r) if t else (r, c)
        N = narrow or N
        n, k = np.arange(N)[:, None], np.arange(K)[None, :]
        src = starts[pack] + off + (k * c + n if t else n * c + k)
        dst = base + slab_offset(k // SLAB_K, n, k % SLAB_K, N if narrow else H)
        index[dst.reshape(-1)] = src.reshape(-1)
        base += stages(entry) * SLAB
    return index


_INDEX: dict = {}


def weight_stream(entries: tuple, *bufs: torch.Tensor) -> torch.Tensor:
    """The stages of ``entries`` (a weight stream) as one flat bf16 buffer,
    gathered from the packs' flat bf16 buffers ``bufs`` (trunk, then
    transposed, then colour, as far as the stream reads).  The index is made
    once per stream and device; no gradient flows through the stream."""
    dev = device_of(bufs[0].device)
    key = (entries, dev)
    if key not in _INDEX:
        _INDEX[key] = to_device(torch.from_numpy(_stream_index(entries)), dev)
    with torch.no_grad():
        flat = torch.cat([bufs[0].new_zeros(1), *bufs])
        return flat.index_select(0, _INDEX[key])


def tile_trunk(pack: dict) -> torch.Tensor:
    """The fused query's trunk stream (``TRUNK_STREAM``, ``N_SLABS`` stages):
    the first stages of the shade's."""
    return weight_stream(TRUNK_STREAM, pack["bf16"])


def tile_shade_fwd(tw: dict, bw: dict, cw: dict) -> torch.Tensor:
    """The render shade's stream (``FWD_STREAM``, ``N_FWD_SLABS`` stages):
    the first stages of the backward's."""
    return weight_stream(FWD_STREAM, tw["bf16"], bw["bf16"], cw["bf16"])


def tile_shade_bwd(tw: dict, bw: dict, cw: dict) -> torch.Tensor:
    """The training shade's stream (``BWD_STREAM``, ``N_BWD_SLABS``
    stages); the kernel returns the weights' gradients in the packs'
    layout."""
    return weight_stream(BWD_STREAM, tw["bf16"], bw["bf16"], cw["bf16"])


# --------------------------------------------------------------------------
# The nets the kernels take
# --------------------------------------------------------------------------

def _emb_width(multires: int) -> int:
    return 3 * (2 * multires + 1)


def supports_fused_query(plan: dict) -> bool:
    """True when the implicit-net plan matches the kernels' static pattern
    (the JAX package's rule)."""
    dims = plan["dims"]
    return (
        plan["raw_in"] == 3
        and plan["multires"] > 0
        and _emb_width(plan["multires"]) <= EMB_PAD
        and tuple(plan["skip_in"]) == (4,)
        and len(dims) == 10
        and all(d == H for d in dims[1:9])
        and dims[9] >= 1
        and (plan["cond"] == "none" or plan["cond_dim"] in (0, 45))
    )


def supports_fused_render(implicit_plan: dict, rendering_plan: dict) -> bool:
    """True when both nets match the shade kernels' static pattern (the JAX
    package's rule)."""
    dims = rendering_plan["dims"]
    return (
        supports_fused_query(implicit_plan)
        and rendering_plan["mode"] == "pose"
        and rendering_plan.get("multires_view", -1) <= 0
        and len(dims) == 6
        and all(d == H for d in dims[1:5])
        and dims[5] == 3
        and dims[0] >= 14 + H
    )


def window_multires(window: torch.Tensor) -> int:
    """The embedding's frequencies from its window's width (E,)."""
    E = window.shape[0]
    if E % 6 != 3 or E > EMB_PAD:
        raise ValueError(f"embedding window of width {E}")
    return (E // 3 - 1) // 2


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------

def _pad(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=torch.float32, device=w.device)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def _views(flat: torch.Tensor, layout: tuple) -> dict:
    """The matrices of ``layout`` as views into its flat buffer, by name."""
    out, off = {}, 0
    for name, r, c in layout:
        out[name] = flat[off:off + r * c].view(r, c)
        off += r * c
    return out


def _packed(mats: dict, layout: tuple) -> dict:
    """``mats`` in ``layout``'s order as one flat bf16 buffer (``"bf16"``),
    with its views by name."""
    flat = torch.cat([mats[n].reshape(-1) for n, _, _ in layout]).to(torch.bfloat16)
    return {"bf16": flat, **_views(flat, layout)}


def packs_of(tw_b, tw_f, bw_b, cw_b, cw_f) -> tuple:
    """The five flat buffers -> (trunk pack, transposed pack, colour pack)
    with their named views, as the pack builders return them."""
    tw = {"bf16": tw_b, "f32": tw_f, **_views(tw_b, TRUNK_LAYOUT),
          "bias": tw_f[:8 * H].view(8, H), "head_w": tw_f[8 * H:9 * H], "head_b": tw_f[9 * H]}
    bw = {"bf16": bw_b, **_views(bw_b, TRANSPOSED_LAYOUT)}
    cw = {"bf16": cw_b, "f32": cw_f, **_views(cw_b, COLOR_LAYOUT), "cbias": cw_f.view(5, H)}
    return tw, bw, cw


def pack_trunk_weights(resolved: dict, plan: dict) -> dict:
    """Resolved ``{'w', 'b'}`` layers -> the trunk pack's two flat buffers.

    ``"bf16"`` holds the nine matrices of ``TRUNK_LAYOUT`` and ``"f32"`` the
    biases and the head; the other keys are views into them by name.  What
    changes numbers is kept from the JAX pack: layer 0 keeps only its first E
    (39) input columns (the 45-d pose condition is zero); the skip layer is
    split as W4h = W4[:, :256-E] / sqrt(2) and W4e = W4[:, 256-E:] / sqrt(2),
    divided BEFORE the bf16 round; biases and the head stay f32.  Layer 3's
    256-E outputs are padded to 256 rows of zeros (its pad activations are
    softplus100(0) = log(2)/100, not 0), so the matching W4h columns are
    zero.  Built under grad mode (the fused training shade), the buffers
    keep the autograd graph back to ``resolved``; the sampler and the render
    build them under ``torch.no_grad``."""
    if not supports_fused_query(plan):
        raise ValueError("unsupported trunk plan for the fused kernels")
    layers = [{k: v.float() for k, v in l.items()} for l in resolved["layers"]]
    E = _emb_width(plan["multires"])
    H3 = H - E
    s2 = float(math.sqrt(2.0))
    w4 = layers[4]["w"]
    mats = {
        "W0": _pad(layers[0]["w"][:, :E], H, EMB_PAD),
        "W3": _pad(layers[3]["w"], H, H),
        "W4h": _pad(w4[:, :H3] / s2, H, H),
        "W4e": _pad(w4[:, H3:H3 + E] / s2, H, EMB_PAD),
    }
    for l in (1, 2, 5, 6, 7):
        mats[f"W{l}"] = layers[l]["w"]
    pack = _packed(mats, TRUNK_LAYOUT)
    bias = torch.stack([_pad(layers[l]["b"][None], 1, H)[0] for l in range(8)])
    fflat = torch.cat([bias.reshape(-1), layers[8]["w"][0], layers[8]["b"][:1]])
    pack.update({"f32": fflat, "bias": fflat[: 8 * H].view(8, H), "head_w": fflat[8 * H: 9 * H],
                 "head_b": fflat[9 * H]})
    return pack


def pack_trunk_transposed(resolved: dict, plan: dict, fwd: dict | None = None) -> dict:
    """Transposed bf16 trunk for the reverse pass, plus the feature head.

    The transposes of ``pack_trunk_weights``'s matrices (``fwd``, built here
    when not given), so forward and reverse see identical effective weights
    (the skip split and its /sqrt(2) included); ``feat_w`` is rows 1: of the
    output layer, (out, in).  Grad mode as for ``pack_trunk_weights``."""
    if fwd is None:
        fwd = pack_trunk_weights(resolved, plan)
    mats = {f"{n}T": fwd[n].t() for n, _, _ in TRUNK_LAYOUT}
    mats["feat_w"] = resolved["layers"][8]["w"].float()[1:]
    return _packed(mats, TRANSPOSED_LAYOUT)


def pack_color_weights(resolved: dict, implicit_resolved: dict) -> dict:
    """Resolved rendering layers -> the colour pack's bf16 weights and f32
    biases.

    Layer 0 is split by input segment: ``C0a`` covers [x_c, normal] (columns
    0:6, padded to 16), ``C0f`` the 256 feature columns (14:270).  The pose
    embedding (6:14) and time code (270:) columns are constant over a frame:
    they and b0 enter as the frame bias (``fused_render.frame_bias0``).
    ``"f32"`` holds the feature head's bias (rows 1: of the implicit output
    layer), then the biases of layers 1, 2, 3 and 4 (3 used), 256 each.
    Grad mode as for ``pack_trunk_weights``."""
    layers = [{k: v.float() for k, v in l.items()} for l in resolved["layers"]]
    w0 = layers[0]["w"]
    mats = {
        "C0a": _pad(w0[:, 0:6], H, C0A),
        "C0f": w0[:, 14:14 + H],
        "C1": layers[1]["w"], "C2": layers[2]["w"], "C3": layers[3]["w"],
        "C4": _pad(layers[4]["w"], 8, H),
    }
    pack = _packed(mats, COLOR_LAYOUT)
    featb = implicit_resolved["layers"][8]["b"].float()[1:]
    cb = torch.cat([featb, layers[1]["b"], layers[2]["b"], layers[3]["b"],
                    _pad(layers[4]["b"][None], 1, H)[0]])
    pack["f32"] = cb
    pack["cbias"] = cb.view(5, H)
    return pack

