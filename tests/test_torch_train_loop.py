"""hold_tpu_torch.train.run_training as a whole on the CPU, at toy size:
step checkpoints and the validation render, resume, --load_ckpt /
--load_pose / --shape_init, the batch-prefetch thread, and the CLI flags
against the JAX package's parser.

A toy scene (widths 64, a short sampler) on a 3-frame synthetic sequence,
one step an epoch.
"""

import copy
import itertools
import json
import os

import numpy as np
import pytest
import torch
from test_torch_train_step import ARGS, _toy_model

from hold_tpu.utils import config as jconfig
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.train import prefetch_batches, run_training
from hold_tpu_torch.utils import config as tconfig
from hold_tpu_torch.utils.checkpoint import latest_checkpoint, read_checkpoint
from hold_tpu_torch.utils.config import Cfg
from hold_tpu_torch.utils.convert import flatten_params

# the JAX package's flags that the port leaves out: none since the multi-process
# and remote-tracker flags came
NOT_PORTED: set = set()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these toy tensors: beside other test workers,
    every tiny op's parallel region would wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_seq():
    built = generate_sequence(None, n_frames=3, img_hw=(48, 64))
    return SequenceData(built["images"], built["masks"], built["data"], num_sample=8)


def _cfg():
    cfg = {"model": _toy_model(), "dataset": copy.deepcopy(jconfig.DEFAULT_CONFIG["dataset"])}
    cfg["dataset"]["train"]["batch_size"] = 1
    return cfg


def _args(log_root, exp_key, **kw):
    return Cfg({**ARGS, "case": "toy", "num_sample": 8, "tempo_len": 1, "offset": 1,
                "log_every": 1, "no_meshing": True, "no_vis": False, "mute": True,
                "eval_every_epoch": 1, "render_downsample": 4, "exp_key": exp_key,
                "log_root": str(log_root), "seed": 0, "total_step": 2, **kw})


def _flat(params):
    return {k: v.detach().clone() for k, v in flatten_params(params).items()}


@pytest.fixture(scope="module")
def source_run(toy_seq, tmp_path_factory):
    """Two steps with validation every epoch: the run the others read."""
    root = tmp_path_factory.mktemp("logs")
    entities = copy.deepcopy(toy_seq.entities)
    params, _, _, tracker, timer, opt = run_training(_args(root, "src"), _cfg(), seq=toy_seq,
                                                     device="cpu")
    return {"root": root, "log_dir": tracker.log_dir, "params": _flat(params),
            "timer": timer, "entities": entities}


def test_run_writes_step_checkpoints_and_validation(source_run):
    log_dir = source_run["log_dir"]
    ckpts = os.path.join(log_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["last.pt", "step_000000001.pt", "step_000000002.pt"]
    assert os.readlink(os.path.join(ckpts, "last.pt")) == "step_000000002.pt"
    state = read_checkpoint(os.path.join(ckpts, "last.pt"))
    assert state["step"] == 2 and set(state) == {"params", "optimizer", "step", "model"}
    for k, v in source_run["params"].items():
        assert torch.equal(state["params"][k], v), k
    visuals = sorted(os.listdir(os.path.join(log_dir, "visuals")))
    assert len(visuals) == 2 and visuals[-1].endswith("_000000002.png")
    import cv2

    panel = cv2.imread(os.path.join(log_dir, "visuals", visuals[-1]))
    assert panel.shape == (12, 16 * 5, 3)  # 48x64 at render_downsample 4, five tiles
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    val = [r for r in recs if "val/psnr" in r]
    assert [r["step"] for r in val] == [1, 2] and all(np.isfinite(r["val/psnr"]) for r in val)
    assert [r["step"] for r in recs if "loss" in r] == [0, 1]
    assert source_run["timer"].counts["val_render"] == 2
    assert source_run["timer"].counts["checkpoint"] == 2


def test_training_leaves_the_sequence_as_read(source_run, toy_seq):
    """The pose tables start as copies of the entities: Adam's in-place
    updates must not reach the sequence that later runs start from."""
    for nid, e in source_run["entities"].items():
        for k, v in e.items():
            np.testing.assert_array_equal(toy_seq.entities[nid][k], v, err_msg=f"{nid}.{k}")


def test_resume_restores_params_adam_state_and_step(source_run, toy_seq):
    root, log_dir = source_run["root"], source_run["log_dir"]
    saved = read_checkpoint(os.path.join(log_dir, "checkpoints", "last.pt"))
    # at the saved step: nothing to run, the state as it was saved
    params, _, _, _, timer, opt = run_training(_args(root, "src"), _cfg(), seq=toy_seq,
                                               device="cpu", max_steps=2)
    assert not timer.counts
    for k, v in flatten_params(params).items():
        assert torch.equal(v.detach(), saved["params"][k]), k
    a, b = opt.state_dict(), saved["optimizer"]
    assert a["param_groups"] == b["param_groups"] and set(a["state"]) == set(b["state"])
    for i, s in b["state"].items():
        for name, t in s.items():
            assert torch.equal(a["state"][i][name], t), (i, name)
    # one more step: it starts at step 2
    run_training(_args(root, "src"), _cfg(), seq=toy_seq, device="cpu", max_steps=3)
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert [r["step"] for r in recs if "loss" in r] == [0, 1, 2]
    assert read_checkpoint(os.path.join(log_dir, "checkpoints", "last.pt"))["step"] == 3


def test_load_flags_change_only_what_they_should(source_run, toy_seq):
    root, src = source_run["root"], source_run["params"]
    src_ckpt = os.path.join(source_run["log_dir"], "checkpoints", "step_000000002.pt")
    # no steps: the parameters each flag starts from
    init, *_ = run_training(_args(root, "init", total_step=0), _cfg(), seq=toy_seq,
                            device="cpu")
    init = _flat(init)
    # --shape_init reads the newest checkpoint of the experiment it names
    newest = read_checkpoint(latest_checkpoint(source_run["log_dir"]))["params"]
    runs = {
        "load_ckpt": ({"load_ckpt": src_ckpt}, src, lambda k: True),
        "load_pose": ({"load_pose": src_ckpt}, src,
                      lambda k: "/tables/" in k or k.endswith("/obj_scale")),
        "shape_init": ({"shape_init": "src"}, newest,
                       lambda k: k.startswith("right/implicit/")),
    }
    for flag, (kw, ref, chosen) in runs.items():
        params, _, _, tracker, _, _ = run_training(_args(root, flag, total_step=0, **kw),
                                                   _cfg(), seq=toy_seq, device="cpu")
        got = _flat(params)
        for k in init:
            assert torch.equal(got[k], ref[k] if chosen(k) else init[k]), (flag, k)
        assert any(not torch.equal(ref[k], init[k]) for k in init if chosen(k)), flag
        # a run that loads another's weights starts at step 0
        assert read_checkpoint(os.path.join(tracker.log_dir, "checkpoints",
                                            "last.pt"))["step"] == 0


def test_prefetch_gives_the_inline_draws_in_order(toy_seq):
    batches = prefetch_batches(toy_seq, np.random.RandomState(3), 2, 1, 8)
    got = list(itertools.islice(batches, 4))
    batches.close()
    rng = np.random.RandomState(3)
    for g in got:
        want = toy_seq.sample_tempo_batch(rng, 2, offset=1, num_sample=8)
        assert set(g) == set(want)
        for k in want:
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)


def _flags(parser):
    return {s: a for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}


def test_cli_has_every_jax_flag_but_multi_host_and_remote():
    jflags, tflags = _flags(jconfig.build_argparser()), _flags(tconfig.build_argparser())
    # the JAX package's sampler switches are the port's flags; its path
    # switches are not: the port chooses each node's path from its nets
    port_only = {"--device", "--seed", "--no_proposal", "--node_bounds", "--sampler_knn_stride",
                 "--sampler_relu"}
    assert port_only <= set(tflags)
    assert set(tflags) - port_only == set(jflags) - NOT_PORTED
    for s, a in tflags.items():
        if s in jflags:
            assert (a.dest, a.default, a.type) == (jflags[s].dest, jflags[s].default,
                                                   jflags[s].type), s


@pytest.mark.parametrize("argv", [
    ["--no_fused_sampler"], ["--no_fused_train"], ["--no_remat"], ["--shade_f32"],
    ["--shade_chunk", "4096"], ["render_cli", "--no_fused_render"],
], ids=lambda a: a[-1] if a[-1].startswith("--") else a[0])
def test_cli_refuses_the_removed_path_switches(argv):
    """The path switches went: each node's path follows from its nets."""
    from hold_tpu_torch import render_cli

    if argv[0] == "render_cli":
        parser, argv = render_cli.build_argparser(), ["--exp", "x", "--case", "toy", *argv[1:]]
    else:
        parser, argv = tconfig.build_argparser(), ["--case", "toy", *argv]
    with pytest.raises(SystemExit):
        parser.parse_args(argv)


@pytest.mark.parametrize("fast", [False, True], ids=["defaults", "fast_dev_run"])
def test_parse_args_matches_jax(fast, tmp_path):
    argv = ["--case", "toy", "--data_root", str(tmp_path)] + (["-f"] if fast else [])
    targs, tcfg = tconfig.parse_args(argv)
    jargs, jcfg = jconfig.parse_args(argv)
    for k, v in targs.items():
        if k in jargs:
            assert v == jargs[k], k
    if fast:
        assert (targs.eval_every_epoch, targs.num_sample, targs.tempo_len, targs.log_every,
                targs.total_step) == (1, 8, 50, 1, 2000)
    # the proposal net on by default, as in the JAX package
    assert tcfg["model"]["proposal"] == jcfg["model"]["proposal"]
    assert tcfg["model"]["proposal"]["enabled"] is True
