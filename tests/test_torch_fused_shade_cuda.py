"""hold_tpu_torch's fused training shade backward (csrc/fused_shade.cu) on the
card against its plain version (``ops/fused_shade.py`` ``shade_train_bwd_plain``)
part by part, at N that are no multiple of the rows kernel's 128-point CTA and
where CTAs straddle frame boundaries, and its column sums bit for bit from
call to call.  Marked ``gpu`` (skipped without a card); no JAX: the packs come
from the port's own init at full width.

The reading is chip_smoke.py's for row 7: a part's worst |d| over 5e-3
|ref| + 5e-3 max|ref|, and the share of its elements beyond that bound, held
by the kind of part to the limits of its smallest N (208 points a frame,
``SHADE_LIMITS[208]``), under seeded cotangents and under those of the JAX
package's test loss.  Under that loss the colour net's parts are held by
chip_smoke.py's rule at these N: on an H100 (kernel | float64 products |
unrounded control, worst and share beyond) N = 129 read 1.564 (0.22 %) |
1.230 (0.12 %) | 3.472 (2.8 %) on ``cw.C0a``, the 258 points' sum of the
colour input's weights, N = 257 and 200 at most 0.786 | 0.419 | 2.676;
the backward with its column sums in a kernel of their own read the same
1.565 at N = 129.  So their cap is 2.0 with 0.25 % beyond, which every
control exceeds.
"""

import numpy as np
import pytest
import torch

from hold_tpu_torch.models.embedders import embed_window
from hold_tpu_torch.models.mlp import (
    implicit_net_shapes, init_implicit_net, init_rendering_net, resolve_weight_norm,
)
from hold_tpu_torch.models.specs import MANO_SPECS
from hold_tpu_torch.ops import fused_shade as fs
from hold_tpu_torch.ops import weight_pack as wp
from hold_tpu_torch.utils.config import DEFAULT_CONFIG

RTOL = ATOL = 5e-3
# kind of part -> (share beyond the bound, cap on worst |d| / bound)
SEEDED = {"point": (0.0, 1.0), "trunk": (2e-2, 8.0), "colour": (1.0, 15.0),
          "frame bias": (0.2, 15.0)}
LOSS = {"point": (5e-4, 4.0), "trunk": (0.0, 0.5), "colour": (2.5e-3, 2.0),
        "frame bias": (1e-3, 2.0)}
COLOUR = ("bw.feat_w", "cw.C0a", "cw.C0f", "cw.C1", "cw.C2", "cw.C3", "cw.cbias0", "cw.cbias1",
          "cw.cbias2", "cw.cbias3")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused training shade's backward is CUDA only")
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _case(dev, b, n, seed=0):
    """The op's arguments at full width on ``dev``: x_c, J^-1, the frame bias,
    the window and the three packs."""
    g = torch.Generator().manual_seed(seed)
    oi = DEFAULT_CONFIG["model"]["implicit_network"]
    iplan = implicit_net_shapes(oi, MANO_SPECS)
    imp = resolve_weight_norm(init_implicit_net(g, oi, MANO_SPECS))
    rend = resolve_weight_norm(init_rendering_net(
        g, DEFAULT_CONFIG["model"]["rendering_network"], MANO_SPECS))
    imp, rend = _to(imp, dev), _to(rend, dev)
    with torch.no_grad():
        tw = wp.pack_trunk_weights(imp, iplan)
        bw = wp.pack_trunk_transposed(imp, iplan, tw)
        cw = wp.pack_color_weights(rend, imp)
    rng = np.random.RandomState(n)
    args = [torch.tensor(a.astype(np.float32), device=dev) for a in (
        rng.randn(b, n, 3) * 0.1, np.eye(3).reshape(9) + rng.randn(b, n, 9) * 0.05,
        rng.randn(b, 256) * 0.1)]
    return [*args, embed_window(iplan, None, (0, 1), dev), tw, bw, cw]


def _parts(g: dict) -> dict:
    """The backward's tensors cut as chip_smoke.py's shade_grad_parts cuts
    them: x_c, J^-1, the frame bias, each matrix of the packs, each bias row."""
    tw, bw, cw = wp.packs_of(g["tw_b"], g["tw_f"], g["bw_b"], g["cw_b"], g["cw_f"])
    parts = {"xc": g["xc"], "jinv9": g["jinv9"], "fb0": g["fb0"]}
    for tag, pack in (("tw", tw), ("bw", bw), ("cw", cw)):
        for k, v in pack.items():
            if k in ("bias", "cbias"):
                parts.update({f"{tag}.{k}{i}": row for i, row in enumerate(v)})
            elif k not in ("bf16", "f32"):
                parts[f"{tag}.{k}"] = v
    return parts


def _kind(name: str, n: int) -> str:
    if name == "fb0":
        return "frame bias"
    if name in COLOUR:
        return "colour"
    return "point" if name.startswith(("xc", "jinv9")) or n == 1 else "trunk"


def _check(got: dict, ref: dict, limits: dict) -> list:
    bad = []
    for k, r in _parts(ref).items():
        g = _parts(got)[k].float()
        r = r.float()
        assert bool(torch.isfinite(g).all()), k
        tol = RTOL * r.abs() + ATOL * max(float(r.abs().max()), 1e-30)
        ratio = (g - r).abs() / tol
        share, cap = limits[_kind(k, r.numel())]
        worst, beyond = float(ratio.max()), float((ratio > 1.0).float().mean())
        if worst > cap or beyond > share:
            bad.append((k, round(worst, 3), beyond))
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(2, 129), (2, 257), (3, 200)])
def test_cuda_backward_matches_plain(cuda, b, n):
    """Row 7's backward kernels against the plain version on the card, part by
    part, under seeded cotangents and under the JAX test loss's."""
    args = _case(cuda, b, n)
    gen = torch.Generator(device=cuda).manual_seed(b * n)
    cts = [torch.randn(s, generator=gen, device=cuda) for s in ((b, n), (b, n, 3), (b, n, 3))]
    got = fs.shade_train_bwd_cuda(*args, *cts)
    torch.cuda.synchronize()
    bad = _check(got, fs.shade_train_bwd_plain(*args, *cts), SEEDED)
    sdf, rgb, nrm = fs.shade_train_plain(*args)
    g_nrm = torch.zeros_like(nrm)
    g_nrm[..., 0] = torch.sign(nrm[..., 0])
    loss_cts = (2.0 * sdf, 2.0 * rgb, g_nrm)
    got = fs.shade_train_bwd_cuda(*args, *loss_cts)
    torch.cuda.synchronize()
    bad += _check(got, fs.shade_train_bwd_plain(*args, *loss_cts), LOSS)
    assert not bad, bad


@pytest.mark.gpu
def test_cuda_backward_sums_are_repeatable(cuda):
    """The bias, head and frame-bias gradients, summed in the rows kernel and
    fused_shade_bwd_kernel_sums in a fixed order, are bit for bit the same
    from call to call (over two chunks and CTAs straddling frames)."""
    b, n = 3, 12_483
    args = _case(cuda, b, n)
    gen = torch.Generator(device=cuda).manual_seed(7)
    cts = [torch.randn(s, generator=gen, device=cuda) for s in ((b, n), (b, n, 3), (b, n, 3))]
    first = fs.shade_train_bwd_cuda(*args, *cts)
    second = fs.shade_train_bwd_cuda(*args, *cts)
    torch.cuda.synchronize()
    for k in ("tw_f", "cw_f", "fb0", "xc", "jinv9"):
        assert torch.equal(first[k], second[k]), k



BITS_MAIN = r"""
__device__ __forceinline__ void ieee(float a, float& h, float& s) {
    const float ex = expf(-fabsf(100.0f * a));
    h = fmaxf(a, 0.0f) + log1pf(ex) / 100.0f;
    s = (a >= 0.0f ? 1.0f : ex) / (1.0f + ex);
}
__device__ __forceinline__ unsigned short bf(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__global__ void count(unsigned long long* c, uint32_t base) {
    const float a = __uint_as_float(base + blockIdx.x * blockDim.x + threadIdx.x);
    if (a != a) return;
    float h0, s0, h1, s1, h2, s2;
    ieee(a, h0, s0);
    softplus_sigmoid_rn(a, h1, s1);
    const bool sure = softplus_sigmoid_bf(a, h2, s2);
    const bool h_differs = __float_as_uint(h1) != __float_as_uint(h0);
    if (__float_as_uint(s1) != __float_as_uint(s0)) atomicAdd(c + 0, 1ull);
    if (bf(h1) != bf(h0)) atomicAdd(c + 1, 1ull);
    if (h_differs && !(h0 < 1.17549435e-38f)) atomicAdd(c + 2, 1ull);
    if (__float_as_uint(s2) != __float_as_uint(s1)) atomicAdd(c + 3, 1ull);
    if (sure && bf(h2) != bf(h1)) atomicAdd(c + 4, 1ull);
    if (h_differs) atomicAdd(c + 5, 1ull);
    if (!sure) atomicAdd(c + 6, 1ull);
    // the head row's gradient takes the series' f32 h where it is sure
    if (sure && h1 >= 1.17549435e-38f && h1 <= 3.40282347e38f && !(fabsf(h2 - h1) <= 1e-6f * h1))
        atomicAdd(c + 7, 1ull);
}
int main() {
    unsigned long long* c;
    unsigned long long r[8];
    if (cudaMalloc(&c, sizeof(r)) != cudaSuccess) return 2;
    cudaMemset(c, 0, sizeof(r));
    for (uint32_t k = 0; k < 4; ++k) count<<<(1u << 30) / 256, 256>>>(c, k << 30);
    if (cudaDeviceSynchronize() != cudaSuccess) return 2;
    cudaMemcpy(r, c, sizeof(r), cudaMemcpyDeviceToHost);
    for (int i = 0; i < 8; ++i) printf("%llu ", r[i]);
    printf("\n");
    return 0;
}
"""


@pytest.mark.gpu
def test_recompute_softplus_sigmoid_is_ieee(cuda, tmp_path):
    """The rows kernel's recompute of softplus and sigmoid over every f32
    input but NaN, against the form that shade_train_bwd_plain rounds like
    (expf, log1pf, IEEE quotients): ``softplus_sigmoid_rn`` (``div_rn`` for
    its quotients) gives s and bf16(h) to the bit, and h too wherever it is
    normal; ``softplus_sigmoid_bf`` gives its s, and its bf16(h) wherever the
    series claims to decide the rounding (elsewhere the kernel takes
    softplus_sigmoid_rn's), and there an f32 h within 1e-6 of its, relative,
    where that is normal (the head row's gradient takes it unrounded)."""
    import re
    import subprocess

    from hold_tpu_torch.ops import _cuda

    src = (_cuda.SRC_DIR / "fused_shade.cu").read_text()

    def device_function(head: str) -> str:
        i = src.index(f"__device__ __forceinline__ {head}")
        return src[i:src.index("\n}\n", i) + 3]

    cu, exe = tmp_path / "bits.cu", tmp_path / "bits"
    cu.write_text("#include <cstdint>\n#include <cstdio>\n#include <cuda_bf16.h>\n"
                  "#include <cuda_runtime.h>\n"
                  + re.search(r"constexpr float H_MARGIN = [^;]*;", src).group(0) + "\n"
                  + "".join(device_function(f) for f in (
                      "float div_rn(", "void softplus_sigmoid_rn(", "float log1p_series(",
                      "bool softplus_sigmoid_bf("))
                  + BITS_MAIN)
    subprocess.run([_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-o", str(exe),
                    str(cu)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    counts = dict(zip(("rn s", "rn bf16(h)", "rn normal h", "bf s", "bf bf16(h)", "rn h",
                       "bf left open", "bf h gap"), map(int, out.split())))
    print(counts)
    must_be_0 = ("rn s", "rn bf16(h)", "rn normal h", "bf s", "bf bf16(h)", "bf h gap")
    assert [counts[k] for k in must_be_0] == [0] * len(must_be_0), counts
