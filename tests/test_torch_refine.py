"""hold_tpu_torch.optimize_ckpt against the JAX package's, end to end on the
CPU: the experiment of tests/test_torch_eval.py (a 3-frame noised synthetic
sequence at 48x64, the toy model, one JAX and one port checkpoint of the
same parameters at step 5, a canonical sphere mesh in misc), copied once for
each package, refined at ``--target_dim 32`` (24x32 masks) with
``--batch_size 2`` (stage 1 on frames 0 and 2, stage 2 on [0, 1] and [2])
and ``--iters 3``, GIFs on.

- ``scale_masks_K`` and ``entity_masks`` equal to JAX's exactly;
- the same kept / rejected decisions, stage by stage and batch by batch;
- the refined tables and obj_scale within 1e-3 of JAX's, a tenth of one
  Adam step at the CLI's lr 1e-2 (read: 7.7e-4 with ``torch.optim.Adam``,
  whose rounding differs from optax's; stage 2 starts from stage 1's betas
  and obj_scale, which agree to ~1e-6, and the near-binary silhouettes at
  sigma 1e-6 amplify that over three fits), while the kept
  fits moved the free tables by more than 1e-2 from the source; the frozen
  tables and every other tensor equal to the source's bit for bit;
- the refined checkpoint (step 999,000,000, ``last.pt`` on it, the source's
  model config, no optimizer state) read by the port's ``load_experiment``
  and ``evaluate`` (finite metrics), and by a training run that resumes in
  the refined experiment: the parameters alone, bit for bit.
- the CLI runs on the card by default: without one it raises
  ``resolve_device``'s error.
"""

import argparse
import contextlib
import copy
import io
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from test_torch_eval import CKPT_STEP, experiment  # noqa: F401 (the fixture)
from test_torch_train_loop import _args, _cfg

from hold_tpu_torch import evaluate as teval
from hold_tpu_torch import optimize_ckpt as topt
from hold_tpu_torch.utils.checkpoint import latest_checkpoint, read_checkpoint

REFINE = {"batch_size": 2, "iters": 3, "target_dim": 32, "inspect_idx": None,
          "freeze_scale": False, "freeze_shape": False, "contact_thres": 0.0, "no_vis": False}
TABLE_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decisions(out: str) -> list:
    """The kept / rejected lines of a refinement's output, in order."""
    return [("stage 1 rejected" if "keeping input scale/shape" in line
             else "kept" if "(kept)" in line else "rejected")
            for line in out.splitlines()
            if "keeping input scale/shape" in line or "IoU" in line and "frames" in line]


@pytest.fixture(scope="module")
def refined(experiment, tmp_path_factory):  # noqa: F811
    """Both packages' refinements, each in its own copy of the experiment."""
    from hold_tpu import optimize_ckpt as jopt  # orbax: not on every host
    from hold_tpu.utils import checkpoint as jckpt

    root = tmp_path_factory.mktemp("refine")
    out = {}
    for side in ("jax", "torch"):
        exp = str(root / side)
        shutil.copytree(experiment["exp"], exp, symlinks=True)
        ckpt = os.path.join(exp, "checkpoints", f"step_{CKPT_STEP:09d}" +
                            (".pt" if side == "torch" else ""))
        args = argparse.Namespace(exp=exp, case="noisy", data_root=experiment["data_root"],
                                  ckpt=ckpt, device="cpu", **REFINE)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            path = (topt if side == "torch" else jopt).refine(args)
        out[side] = {"exp": exp, "path": path, "log": buf.getvalue(), "src": ckpt}
    jstate = jckpt.load_checkpoint(out["jax"]["path"], {"params": None, "step": 0})
    out["jax"]["params"] = jstate["params"]
    out["torch"]["state"] = read_checkpoint(out["torch"]["path"])
    return out


def test_mask_scaling_matches_jax():
    from hold_tpu import optimize_ckpt as jopt  # orbax: not on every host

    rng = np.random.RandomState(0)
    masks = rng.choice([0, 50, 100, 150, 200], (3, 48, 64)).astype(np.float32)
    K = np.array([[70.0, 0, 31.5], [0, 70.0, 23.5], [0, 0, 1]])
    for dim in (32, 300):
        got, want = topt.scale_masks_K(masks, K, dim), jopt.scale_masks_K(masks, K, dim)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        for nids in (["right", "object"], ["right", "left", "object"]):
            a, b = topt.entity_masks(got[0], nids), jopt.entity_masks(want[0], nids)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_refine_decides_as_jax(refined):
    got, want = _decisions(refined["torch"]["log"]), _decisions(refined["jax"]["log"])
    assert len(want) == 2 and got == want, (got, want)  # stage 2: two batches
    for side in ("jax", "torch"):
        fit_vis = os.path.join(refined[side]["exp"], "fit_vis")
        assert sorted(os.listdir(fit_vis)) == ["stage1.gif", "stage2_0000.gif",
                                               "stage2_0002.gif"], side


def test_refined_tables_match_jax(refined):
    jp, tp = refined["jax"]["params"], refined["torch"]["state"]["params"]
    src = read_checkpoint(refined["torch"]["src"])["params"]
    moved = 0.0
    for nid in ("right", "object"):
        for k, v in jp[nid]["tables"].items():
            got = tp[f"{nid}/tables/{k}"].numpy()
            np.testing.assert_allclose(got, np.asarray(v), rtol=0, atol=TABLE_ATOL,
                                       err_msg=f"{nid}.{k}")
            moved = max(moved, float(np.abs(got - src[f"{nid}/tables/{k}"].numpy()).max()))
            if k in ("pose",) or (nid == "right" and k == "global_orient"):
                np.testing.assert_array_equal(got, src[f"{nid}/tables/{k}"].numpy())
    np.testing.assert_allclose(float(tp["object/obj_scale"]), float(jp["object"]["obj_scale"]),
                               rtol=0, atol=TABLE_ATOL)
    # every other tensor is the source's
    for k, v in src.items():
        if "/tables/" not in k and k != "object/obj_scale":
            assert torch.equal(tp[k], v), k
    # the kept fits moved the free tables far beyond the limit
    assert "kept" in _decisions(refined["torch"]["log"]) and moved > 10 * TABLE_ATOL, moved


def test_refined_checkpoint_is_read_by_the_port(refined, experiment):
    from hold_tpu_torch.eval.io_pred import load_experiment

    exp = refined["torch"]["exp"]
    state = refined["torch"]["state"]
    assert state["step"] == topt.STEP_TAG and state["optimizer"] is None
    assert state["model"] == read_checkpoint(refined["torch"]["src"])["model"]
    assert os.path.realpath(latest_checkpoint(exp)) == os.path.realpath(refined["torch"]["path"])
    params, misc, scene = load_experiment(exp, experiment["tseq"], "cpu")
    np.testing.assert_array_equal(params["right"]["tables"]["transl"].detach().numpy(),
                                  state["params"]["right/tables/transl"].numpy())
    rec = teval.main(["--exp", exp, "--case", "noisy", "--data_root", experiment["data_root"],
                      "--icp_iters", "1", "--device", "cpu"])
    assert all(np.isfinite(v) for k, v in rec["mean"].items() if isinstance(v, float))
    assert {"mpjpe_ra_r", "cd_icp"} <= set(rec["mean"])


def test_training_resumes_the_refined_parameters_alone(refined, experiment):
    """``run_training`` in a refined experiment resumes from step
    999,000,000: its parameters, no optimizer state (the refinement keeps
    none), and no step to run."""
    from hold_tpu_torch.train import run_training
    from hold_tpu_torch.utils.convert import flatten_params

    exp = refined["torch"]["exp"]
    cfg = _cfg()
    cfg["model"] = copy.deepcopy(refined["torch"]["state"]["model"])
    args = _args(os.path.dirname(exp), os.path.basename(exp), case="noisy", no_vis=True)
    params, *_, optimizer = run_training(args, cfg, seq=experiment["tseq"], device="cpu")
    want = refined["torch"]["state"]["params"]
    got = flatten_params(params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k
    assert optimizer.state_dict()["state"] == {}


def test_cli_needs_the_card_unless_asked(experiment):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topt.main(["--exp", "x", "--case", "noisy", "--data_root", experiment["data_root"]])


def test_cli_flags_match_jax(monkeypatch):
    """Every flag of the JAX CLI with its default, and ``--device``."""
    from hold_tpu import optimize_ckpt as jopt  # orbax: not on every host
    from hold_tpu.utils import compile_cache

    captured = {}
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(jopt, "refine", lambda args: captured.update(vars(args)))
    monkeypatch.setattr(sys, "argv", ["optimize_ckpt", "--exp", "e", "--case", "c"])
    jopt.main()
    ours = vars(topt.build_argparser().parse_args(["--exp", "e", "--case", "c"]))
    assert {k: v for k, v in ours.items() if k != "device"} == captured
    assert ours["device"] == "cuda"
