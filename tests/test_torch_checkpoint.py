"""hold_tpu_torch/utils/checkpoint.py: step checkpoints, the newest one, the
merge into a template, and the filtered loads of --load_pose and
--shape_init against the JAX package's.

Toy scenes (widths 64) from the port's synthetic generator; the subset
loads are compared on a two-hand scene, the JAX side through its own
``save_checkpoint`` / ``load_params_subset`` (orbax) and its run_training's
predicates, the port's through its checkpoint files and predicates.
"""

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_train_step import ARGS, _toy_model

from hold_tpu.models import holdnet as jhn
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.train import hand_shape_subset, optimizer_for, pose_subset
from hold_tpu_torch.utils import checkpoint as tckpt
from hold_tpu_torch.utils.config import Cfg
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax

# hold_tpu/train.py's --load_pose and --shape_init predicates (:202-227)
JAX_PREDICATES = {
    "load_pose": lambda path: "tables" in path or path[-1:] == ("obj_scale",),
    "shape_init": lambda path: len(path) >= 2 and path[0] in ("right", "left")
    and path[1] == "implicit",
}
PORT_PREDICATES = {"load_pose": pose_subset, "shape_init": hand_shape_subset}


def _scene(two_hands=False):
    built = generate_sequence(None, n_frames=3, img_hw=(48, 64), two_hands=two_hands)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    return seq.scene_data(), thn.build_scene(_toy_model(), ARGS, seq.scene_data(), "cpu")


@pytest.fixture(scope="module")
def trained():
    """Params and Adam state after two steps of seeded gradients."""
    sd, scene = _scene()
    params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, sd)
    opt = optimizer_for(Cfg({"lr": 1e-3}), params)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        for t in flatten_params(params).values():
            if t.requires_grad:
                t.grad = torch.randn(t.shape, generator=gen)
        opt.step()
    return sd, scene, params, opt


def _fresh(sd, scene, seed=5):
    return thn.init_scene_params(torch.Generator().manual_seed(seed), scene, sd)


def test_round_trip_is_exact(trained, tmp_path):
    sd, scene, params, opt = trained
    path = tckpt.save_checkpoint(str(tmp_path), 12, tckpt.training_state(params, opt, 12, {}))
    assert os.path.basename(path) == "step_000000012.pt"
    fresh = _fresh(sd, scene)
    state = tckpt.load_checkpoint(path, {"params": fresh, "optimizer": None, "step": 0})
    assert state["step"] == 12
    got, ref = flatten_params(state["params"]), flatten_params(params)
    assert set(got) == set(ref)
    for k, t in ref.items():
        assert torch.equal(got[k], t.detach()), k
        assert got[k].requires_grad == t.requires_grad and got[k].is_leaf, k
    opt2 = optimizer_for(Cfg({"lr": 1e-3}), state["params"])
    opt2.load_state_dict(state["optimizer"])
    a, b = opt.state_dict(), opt2.state_dict()
    assert a["param_groups"] == b["param_groups"] and set(a["state"]) == set(b["state"])
    for i, s in a["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], b["state"][i][name]), (i, name)


def test_latest_checkpoint_picks_the_newest(trained, tmp_path):
    _, _, params, opt = trained
    log_dir = str(tmp_path)
    assert tckpt.latest_checkpoint(log_dir) is None
    for step in (3, 10, 7):
        tckpt.save_checkpoint(log_dir, step, tckpt.training_state(params, opt, step, {}))
    last = os.path.join(log_dir, "checkpoints", "last.pt")
    assert tckpt.latest_checkpoint(log_dir) == last
    assert os.readlink(last) == "step_000000007.pt"  # the last written, as JAX's `last`
    assert tckpt.read_checkpoint(last)["step"] == 7
    assert not any(f.endswith(".tmp") for f in os.listdir(os.path.dirname(last)))
    os.remove(last)  # without last.pt: the highest step
    assert tckpt.latest_checkpoint(log_dir).endswith("step_000000010.pt")


def test_missing_subtree_keeps_the_template_init(trained, tmp_path):
    sd, scene, params, opt = trained
    state = tckpt.training_state(params, opt, 4, {})
    state["params"] = {k: v for k, v in state["params"].items()
                       if not k.startswith("background/")}
    del state["optimizer"]
    path = tckpt.save_checkpoint(str(tmp_path), 4, state)
    fresh = _fresh(sd, scene)
    got = tckpt.load_checkpoint(path, {"params": fresh, "optimizer": None, "step": 0})
    assert got["optimizer"] is None and got["step"] == 4
    flat, ref, init = (flatten_params(got["params"]), flatten_params(params),
                       flatten_params(fresh))
    for k in flat:
        want = init[k] if k.startswith("background/") else ref[k]
        assert torch.equal(flat[k], want.detach()), k


@pytest.fixture(scope="module")
def two_hand_params():
    """Params of a toy two-hand scene in the JAX package's layout (its
    init's tree and shapes, traced without running it; seeded values), and
    the same params with every tensor moved."""
    sd, _ = _scene(two_hands=True)
    jscene = jhn.build_scene(_toy_model(), ARGS, sd)
    shapes = jax.eval_shape(lambda key: jhn.init_scene_params(key, jscene, sd),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    base = jax.tree_util.tree_map(lambda s: np.asarray(rng.randn(*s.shape), s.dtype), shapes)
    return base, jax.tree_util.tree_map(lambda x: x + 1.0, base)


@pytest.mark.parametrize("flag", ["load_pose", "shape_init"])
def test_subset_loads_select_what_jax_selects(flag, two_hand_params, tmp_path):
    from hold_tpu.utils import checkpoint as jckpt  # orbax: not on every host

    base, other = two_hand_params
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, {"params": other, "step": 5})
    jres = jckpt.load_params_subset(str(tmp_path / "jax" / "checkpoints" / "last"), base,
                                    JAX_PREDICATES[flag])
    tpath = tckpt.save_checkpoint(str(tmp_path / "torch"), 5, {
        "params": flatten_params(params_from_jax(jax.device_get(other))), "step": 5})
    tres = tckpt.load_params_subset(tpath, params_from_jax(jax.device_get(base)),
                                    PORT_PREDICATES[flag])
    want = flatten_params(params_from_jax(jax.device_get(jres)))
    got = flatten_params(tres)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].detach(), want[k].detach()), k
    b = flatten_params(params_from_jax(jax.device_get(base)))
    chosen = {k for k in got if not torch.equal(got[k].detach(), b[k].detach())}
    assert chosen
    if flag == "shape_init":
        assert chosen == {k for k in got if k.split("/")[1] == "implicit"
                          and k.split("/")[0] in ("right", "left")}
        assert any(k.startswith("left/") for k in chosen)
    else:
        assert chosen == {k for k in got if "/tables/" in k or k.endswith("/obj_scale")}


def test_args_json_with_the_removed_path_keys_loads_the_default_paths(tmp_path):
    """A run written before the path switches went keeps them in its
    args.json: ``load_experiment`` ignores them and rebuilds each node's
    paths from its nets (full width: the fused query and the fused shade)."""
    import copy
    import json

    from hold_tpu_torch.utils.config import DEFAULT_CONFIG

    built = generate_sequence(None, n_frames=3, img_hw=(48, 64))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    model = copy.deepcopy(DEFAULT_CONFIG["model"])
    model["proposal"]["enabled"] = False
    scene = thn.build_scene(dict(model, scene_bounding_sphere=seq.scene_bounding_sphere), ARGS,
                            seq.scene_data(), "cpu")
    params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    exp = str(tmp_path / "old_run")
    tckpt.save_checkpoint(exp, 3, {"params": {k: v.detach()
                                              for k, v in flatten_params(params).items()},
                                   "step": 3, "model": model})
    old = {**ARGS, "no_fused_sampler": True, "no_fused_train": True, "no_remat": True,
           "shade_f32": True, "shade_chunk": 64}
    with open(os.path.join(exp, "args.json"), "w") as f:
        json.dump(old, f)
    loaded, got, step = tckpt.load_experiment(exp, seq, "cpu")
    assert step == 3
    for nid in got.node_ids:
        p, want = got.plans[nid], scene.plans[nid]
        assert (p.fused_query, p.fused_shade, p.shade_bf16) == (True, True, False), nid
        assert (p.implicit, p.rendering, p.sampler) == (want.implicit, want.rendering,
                                                        want.sampler), nid
    for k, t in flatten_params(params).items():
        assert torch.equal(flatten_params(loaded)[k], t), k
