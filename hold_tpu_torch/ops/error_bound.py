"""The error-bound sampler's rounds on the card (``csrc/error_bound.cu``).

``render/ray_sampler.py::error_bound_z_vals`` refines each ray's z table in
``max_total_iters - 1`` rounds and a last step, with a query of the new
samples between them.  ``eb_round`` is a round in one launch, one block a
ray: the previous round's samples and their sdf merged into the table, beta
bisected on it, the next samples drawn at the grid.  ``eb_final`` is the
last step: the merge and the bisection, then the final samples at the given
draws with near, far and the extra table entries, sorted.  Every draw is
made by the caller.

The numbers are those of ``ray_sampler.error_bound_round_plain`` and
``error_bound_final_plain``, op by op, but for the order of the sums (see
the source).  No TPU kernel did this: the JAX package leaves it to XLA.

CUDA tensors only; ``ray_sampler`` runs the plain steps on the CPU.  Each
launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import torch

from . import _cuda

LAUNCHES = {"eb_round": 0, "eb_final": 0}
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _table(z_vals, sdf, new, new_sdf, beta, beta0, m: int) -> tuple:
    """The checked table arguments, as hold_eb_round / hold_eb_final take
    them: (z, sdf, new z or None, new sdf or None, beta, beta0 (1,), R, S,
    Ne)."""
    R, S = z_vals.shape
    Ne = 0 if new is None else new.shape[1]
    z_vals, sdf = z_vals.contiguous(), sdf.contiguous()
    _cuda.check(z_vals, "z_vals", (R, S))
    _cuda.check(sdf, "sdf", (R, S))
    if Ne:
        new, new_sdf = new.contiguous(), new_sdf.contiguous()
        _cuda.check(new, "new", (R, Ne))
        _cuda.check(new_sdf, "new_sdf", (R, Ne))
    beta, beta0 = beta.contiguous(), beta0.reshape(1)
    _cuda.check(beta, "beta", (R,))
    _cuda.check(beta0, "beta0", (1,))
    if S + Ne < 2:
        raise ValueError("error-bound table: needs at least two samples a ray")
    smem = _cuda.lib().hold_eb_smem_bytes(S + Ne, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"error-bound table of {S + Ne} samples: {smem} bytes of shared "
                         f"memory a ray, above {SMEM_LIMIT}")
    return z_vals, sdf, new if Ne else None, new_sdf if Ne else None, beta, beta0, R, S, Ne


def _check_rows(t, name: str, R: int) -> None:
    """Raise unless ``t`` is a CUDA float32 (R, 1) tensor (rows any stride
    apart)."""
    if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != (R, 1):
        raise ValueError(f"{name}: expected a CUDA float32 tensor of shape {(R, 1)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def eb_round(z_vals, sdf, new, new_sdf, beta, beta0, u, cfg) -> tuple:
    """One round (``error_bound_round_plain``): table (R, S), the previous
    round's samples and sdf (R, Ne) or None, beta (R,), beta0 (a 0-d
    tensor), the grid u (Nu,) -> (table z, table sdf (R, S + Ne), beta (R,),
    samples (R, Nu))."""
    z_vals, sdf, new, new_sdf, beta, beta0, R, S, Ne = _table(z_vals, sdf, new, new_sdf, beta,
                                                             beta0, 1)
    Nu = u.shape[0]
    u = u.contiguous()
    _cuda.check(u, "u", (Nu,))
    dev = z_vals.device
    if Ne:
        z_out = torch.empty((R, S + Ne), dtype=torch.float32, device=dev)
        sdf_out = torch.empty_like(z_out)
    else:
        z_out, sdf_out = z_vals, sdf
    beta_out = torch.empty((R,), dtype=torch.float32, device=dev)
    samples = torch.empty((R, Nu), dtype=torch.float32, device=dev)
    _cuda.launch("hold_eb_round", z_vals.data_ptr(), sdf.data_ptr(), _ptr(new), _ptr(new_sdf),
                 beta.data_ptr(), beta0.data_ptr(), z_out.data_ptr(), sdf_out.data_ptr(),
                 beta_out.data_ptr(), u.data_ptr(), samples.data_ptr(), R, S, Ne, Nu,
                 cfg.beta_iters, int(cfg.conv_check == "beta0"), cfg.eps, cfg.add_tiny)
    LAUNCHES["eb_round"] += 1
    return z_out, sdf_out, beta_out, samples


def eb_final(z_vals, sdf, new, new_sdf, beta, beta0, u, idx, near, far, cfg) -> torch.Tensor:
    """The last step (``error_bound_final_plain``): the table as
    ``eb_round`` takes it, the draws u (R, N) or the grid (N,), the extras'
    table positions idx (E,) int64 or None, near and far (R, 1) ->
    (R, N + 2 + E) sorted."""
    N = u.shape[-1]
    E = 0 if idx is None else idx.shape[0]
    z_vals, sdf, new, new_sdf, beta, beta0, R, S, Ne = _table(z_vals, sdf, new, new_sdf, beta,
                                                             beta0, N + 2 + E)
    u = u.contiguous()
    _cuda.check(u, "u", (R, N) if u.dim() == 2 else (N,))
    if E:
        _cuda.check(idx, "idx", (E,), torch.int64)
    _check_rows(near, "near", R)
    _check_rows(far, "far", R)
    out = torch.empty((R, N + 2 + E), dtype=torch.float32, device=z_vals.device)
    _cuda.launch("hold_eb_final", z_vals.data_ptr(), sdf.data_ptr(), _ptr(new), _ptr(new_sdf),
                 beta.data_ptr(), beta0.data_ptr(), u.data_ptr(), _ptr(idx), near.data_ptr(),
                 far.data_ptr(), out.data_ptr(), R, S, Ne, N, N if u.dim() == 2 else 0, E,
                 near.stride(0), far.stride(0), cfg.beta_iters, int(cfg.conv_check == "beta0"),
                 cfg.eps)
    LAUNCHES["eb_final"] += 1
    return out
