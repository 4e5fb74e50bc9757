"""The control, the plain reference with its bf16 products in float8 e4m3
and the rest in TF32, put in the program's place, fails the comparison:
at toy widths on the CPU, and on the card (``gpu``); ``calibrate.py``
reads it at each cell's own size."""

import numpy as np
import pytest
import torch

from holdbench import compare, run
from holdbench.entries import render as R
from holdbench.entries import train as T


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_train_control_fails(toy_root, dev):
    dev = _device(dev)
    cell = run.load_cell("toy_train")
    cfg = run.load_json("configs", cell["config"])
    inp = T.inputs(cell, cfg)
    prog = T.Program(cell, cfg, inp, 5, dev)
    rec = T.first_steps(prog, int(cell["compare_steps"]))
    prog.close()
    ref = T.reference_steps(cfg, inp, prog.base, rec, dev)
    ctl = T.reference_steps(cfg, inp, prog.base, rec, dev, control=True)
    radius = inp["opt_model"]["scene_bounding_sphere"]
    assert compare.checks(T.readings(rec, ref, radius)[0], cell["limits"])[0]
    ok, checked = compare.checks(T.readings(ctl, ref, radius)[0], cell["limits"])
    assert not ok, checked


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_render_control_fails(toy_root, dev):
    dev = _device(dev)
    cell = run.load_cell("toy_render")
    cfg = run.load_json("configs", cell["config"])
    inp = R.inputs(cell, cfg)
    prog = R.Program(cell, cfg, inp, 5, dev)
    rng = np.random.RandomState(7)
    frames = []
    for idx in range(2):
        frames.append((prog.data.full_frame_batch(idx, downsample=prog.down),
                       R.pixel_sample(prog.data, idx, prog.down, 64, rng)))
    ref = R.reference_maps(cfg, inp, prog.base, frames, dev)
    ctl = R.reference_maps(cfg, inp, prog.base, frames, dev, control=True)
    cat = [{k: np.concatenate([r[k] for r in x]) for k in x[0]} for x in (ref, ctl)]
    gap, worst = compare.map_gap(cat[1], cat[0])
    assert gap > cell["limits"]["maps"], (gap, worst)
