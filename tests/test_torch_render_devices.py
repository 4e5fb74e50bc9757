"""``render_cli`` over several devices (the JAX CLI's ``make_mesh(0)`` render).

The port renders each chunk over every local card: one process a card, each
chunk's pixels split over the ranks and gathered, rank 0 alone writing.  On
the CPU, two gloo ranks (one intra-op thread each, under a deadline) render
a toy experiment (the widths-64 model of tests/test_torch_train_step.py,
random weights from seed 0, 2 frames at 24x32) through
``render_cli.render_on(args, ["cpu", "cpu"])``.  Checked:

- the PNG panels and fp16 normals they write equal one process's bit for
  bit, and so do the maps;
- the maps agree with the JAX package's ``render_frame(..., mesh=make_mesh(2))``
  on two of the 8 virtual CPU devices within the render tolerances of
  tests/test_torch_fused_render.py::test_render_frame_matches_jax;
- ``--pixel_per_batch`` is rounded up to a multiple of the ranks.
"""

import argparse
import json
import os

import cv2
import numpy as np
import pytest
import torch

from hold_tpu.data.dataset import SequenceData as JSequenceData
from hold_tpu.models import holdnet as jhn
from hold_tpu.parallel.sharding import make_mesh
from hold_tpu.render import renderer as jrenderer
from hold_tpu_torch import render_cli
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.utils.checkpoint import save_checkpoint
from hold_tpu_torch.utils.convert import flatten_params
from test_torch_train_step import _toy_model, jax_params_of

FRAMES, DOWNSAMPLE, PIXELS = 2, 2, 256  # 24x32 frames: 3 chunks of 256, 128 a rank
DEADLINE_S = 240.0
# test_torch_fused_render.py::test_render_frame_matches_jax's bounds: the two
# packages' samplers place their bf16-queried samples a tenth of a spacing
# apart, which moves the maps where a ray grazes a surface
JAX_TOL = {"rgb": 2e-3, "fg_rgb_vis": 3e-2, "bg_rgb_only": 1e-5, "normal": 5e-2,
           "depth": 5e-2, "mask_prob": 5e-2}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A 2-frame synthetic sequence and one experiment dir holding a port
    checkpoint of the toy model at the port's init."""
    root = tmp_path_factory.mktemp("render_devices")
    data_root = str(root / "data")
    generate_sequence(os.path.join(data_root, "toy"), FRAMES, (48, 64), seed=2)
    seq = SequenceData.from_build_dir("toy", data_root)
    model = dict(_toy_model(), scene_bounding_sphere=seq.scene_bounding_sphere)
    scene = thn.build_scene(model, {}, seq.scene_data(), "cpu")
    params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    exp = str(root / "exp")
    save_checkpoint(exp, 1, {"params": {k: v.detach() for k, v in flatten_params(params).items()},
                             "step": 1, "model": _toy_model()})
    with open(os.path.join(exp, "args.json"), "w") as f:
        json.dump({}, f)
    return {"root": root, "data_root": data_root, "exp": exp, "model": model, "seq": seq,
            "params": params}


def _args(experiment, tag):
    return argparse.Namespace(
        exp=experiment["exp"], case="toy", data_root=experiment["data_root"],
        render_downsample=DOWNSAMPLE, agent_id=0, num_agents=1, pixel_per_batch=PIXELS,
        out=str(experiment["root"] / tag / "renders"),
        export_root=str(experiment["root"] / tag / "exports"), device="cpu")


@pytest.fixture(scope="module")
def renders(experiment):
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # each spawned rank: one intra-op thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = render_cli.render_on(_args(experiment, "one"), ["cpu"])
        two = render_cli.render_on(_args(experiment, "two"), ["cpu", "cpu"],
                                   timeout=DEADLINE_S)
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return {"one": one, "two": two}


def test_two_ranks_write_one_process_files_bit_for_bit(experiment, renders):
    assert len(renders["one"]) == 1 and len(renders["two"]) == 2
    root = experiment["root"]
    for idx in range(FRAMES):
        one = cv2.imread(str(root / "one" / "renders" / f"{idx:04d}.png"))
        two = cv2.imread(str(root / "two" / "renders" / f"{idx:04d}.png"))
        assert one.shape == (24, 32 * 5, 3)
        np.testing.assert_array_equal(two, one)
        n_one = np.load(root / "one" / "exports" / "exp" / "normal" / f"{idx:04d}.npy")
        n_two = np.load(root / "two" / "exports" / "exp" / "normal" / f"{idx:04d}.npy")
        assert n_one.dtype == np.float16 and n_one.shape == (24, 32, 3)
        np.testing.assert_array_equal(n_two, n_one)
    # the maps too, on both ranks (each holds the gathered chunks)
    for rank in renders["two"]:
        for rec, ref in zip(rank, renders["one"][0]):
            assert rec["idx"] == ref["idx"]
            for k, v in ref["res"].items():
                np.testing.assert_array_equal(rec["res"][k], v, err_msg=k)


def test_two_ranks_match_the_jax_mesh_render(experiment, renders):
    jseq = JSequenceData("toy", experiment["data_root"])
    jscene = jhn.build_scene(experiment["model"], {}, jseq.scene_data())
    jparams = jax_params_of(experiment["params"], jscene, jseq.scene_data())
    mesh = make_mesh(2)
    assert mesh.devices.size == 2
    for rec in renders["two"][0]:
        jfb = jseq.full_frame_batch(rec["idx"], downsample=DOWNSAMPLE)
        ref = jrenderer.render_frame(jparams, jscene, jhn.empty_object_mesh_state(), jfb,
                                     pixel_per_batch=PIXELS, mesh=mesh)
        got = rec["res"]
        assert set(got) == set(ref)
        for k, tol in JAX_TOL.items():
            d = float(np.abs(got[k] - np.asarray(ref[k])).max())
            assert d <= tol, (rec["idx"], k, d)


@pytest.mark.parametrize("ppb,world,want", [(4096, 1, 4096), (4096, 2, 4096), (4096, 3, 4098),
                                            (255, 2, 256), (1, 8, 8)])
def test_pixel_per_batch_rounds_up_to_the_ranks(ppb, world, want):
    assert render_cli.chunk_pixels(ppb, world) == want
    assert want % world == 0 and 0 <= want - ppb < world
