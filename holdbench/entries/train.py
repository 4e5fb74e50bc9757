"""Training cells: the window drives the port's ``make_train_step``
``train_step``, the step ``run_training`` calls, on batches drawn by
``prefetch_batches`` as ``run_training`` draws them, every step numbered
past the proposal's warmup (the sampler in proposal mode).

Set-up builds the scene, the parameters (from the seed, on the card), the
object's mesh state (filled as a run's meshing fills it) and Adam, then
runs the cell's first steps through the same ``train_step``: they warm up
every shape, and they are the steps the reference follows.  After the
window the program's state is freed and the plain reference runs those
steps again from the same parameters, batches and random draws.  A traced
run profiles ``trace_steps`` steps of the window's ``train_step``, then
times as many more through one built with the port's ``StepTimer`` for
the stage walls, outside the profile: the timer synchronises the device.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import time

import numpy as np
import torch

from .. import compare, counts, device, weights
from ..reference import mlp as ref_mlp
from ..reference import model as ref_model
from ..synthetic import generate_sequence, geodesic_sphere
from ..trace import Traced, span

BETA1 = 0.9


def inputs(cell: dict, cfg: dict) -> dict:
    """What both sides read: the sequence, the object's canonical mesh, the
    model config (the scene's radius filled in)."""
    seqc = cfg["sequence"]
    seq = generate_sequence(seqc["frames"], (seqc["height"], seqc["width"]),
                            two_hands=len(cfg["hands"]) == 2)
    mesh = geodesic_sphere(cfg["object_mesh"]["radius"], cfg["object_mesh"]["frequency"])
    opt_model = copy.deepcopy(cfg["model"])
    opt_model["scene_bounding_sphere"] = float(seq["data"]["scene_bounding_sphere"])
    return {"seq": seq, "mesh": mesh, "opt_model": opt_model}


def _batch_dev(batch_np: dict, dev) -> dict:
    out = {}
    for k, v in batch_np.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(dev, torch.long if k == "frame_idx" else torch.float32)
    return out


class Program:
    """The port's training objects for one seed."""

    def __init__(self, cell: dict, cfg: dict, inp: dict, seed: int, dev):
        from hold_tpu_torch.data.dataset import SequenceData
        from hold_tpu_torch.models.holdnet import build_scene, object_mesh_state_from_mesh
        from hold_tpu_torch.train import make_train_step, optimizer_for, prefetch_batches
        from hold_tpu_torch.utils.config import Cfg
        from hold_tpu_torch.utils.convert import leaf_params

        tr = cfg["train"]
        seq = inp["seq"]
        self.data = SequenceData(seq["images"], seq["masks"], seq["data"],
                                 num_sample=cell["rays_per_frame"])
        self.args = Cfg(lr=tr["lr"], barf_s=tr["barf_s"], barf_e=tr["barf_e"],
                        freeze_pose=False)
        self.scene = build_scene(inp["opt_model"], self.args, self.data.scene_data(), dev)
        self.base = weights.make_params(inp["opt_model"], seq["data"]["entities"],
                                        self.data.n_frames, seed, dev)
        self.params = leaf_params(weights.map_tree(self.base, lambda t: t.clone()), dev)
        self.mesh_state = object_mesh_state_from_mesh(*inp["mesh"], dev)
        self.optimizer = optimizer_for(self.args, self.params,
                                       inp["opt_model"]["proposal"]["lr"])
        self.train_step = make_train_step(self.scene, self.optimizer)
        self.gen = torch.Generator(dev).manual_seed(int(seed) + 1)
        self.batches = prefetch_batches(self.data, np.random.RandomState(int(seed) % 2 ** 32),
                                        tr["batch_size"], tr["offset"], cell["rays_per_frame"])
        self.step = int(cell["first_step"])
        self.steps_per_epoch = max(tr["tempo_len"] // tr["batch_size"], 1)
        self.dev = dev

    def next_batch(self) -> tuple:
        with span("data"):
            batch_np = next(self.batches)
            return batch_np, _batch_dev(batch_np, self.dev)

    def run_step(self, batch) -> dict:
        with span("step"):
            aux = self.train_step(self.params, batch, self.mesh_state, self.gen, self.step,
                                  self.step // self.steps_per_epoch)
        self.step += 1
        return aux

    def timed_phases(self, n: int) -> dict:
        """``n`` more steps through a ``train_step`` of the same scene and
        Adam built with the port's ``StepTimer``, which synchronises the
        device at each phase's end: each phase's mean wall (s)."""
        from hold_tpu_torch.train import make_train_step
        from hold_tpu_torch.utils.logger import StepTimer

        timer = StepTimer()
        untimed, self.train_step = self.train_step, make_train_step(self.scene, self.optimizer,
                                                                   timer)
        try:
            for _ in range(n):
                self.run_step(self.next_batch()[1])
        finally:
            self.train_step = untimed
        return timer.summary()

    def close(self):
        self.batches.close()


@contextlib.contextmanager
def sampler_span():
    """A host span ``sampler`` around each call into the sampler stage (the
    port's ``sample_all_z`` as ``train_step`` looks it up)."""
    import hold_tpu_torch.train as train_mod

    sample_all_z = train_mod.sample_all_z

    def spanned(*a, **k):
        with span("sampler"):
            return sample_all_z(*a, **k)

    train_mod.sample_all_z = spanned
    try:
        yield
    finally:
        train_mod.sample_all_z = sample_all_z


def first_steps(prog: Program, n: int) -> dict:
    """The cell's first ``n`` steps through ``train_step``, with what the
    reference needs to follow them (batches, steps, the generator's state
    before each step) and what they produced: each step's loss, the first
    step's z tables (read from the sampler stage's return), the first
    gradient as Adam holds it, the parameters' change after ``n`` steps."""
    import hold_tpu_torch.train as train_mod

    rec = {"batches": [], "steps": [], "gen_before": [], "gen_after": [], "loss": [],
           "zs": []}
    sample_all_z = train_mod.sample_all_z

    def recorded(*a, **k):
        out = sample_all_z(*a, **k)
        rec["zs"].append({nid: z.detach().clone() for nid, z in out.items()})
        return out

    train_mod.sample_all_z = recorded
    try:
        for i in range(n):
            batch_np, batch = prog.next_batch()
            rec["batches"].append(batch_np)
            rec["steps"].append(prog.step)
            rec["gen_before"].append(prog.gen.get_state())
            aux = prog.run_step(batch)
            rec["loss"].append(float(aux["loss"]))
            rec["gen_after"].append(prog.gen.get_state())
            if i == 0:
                rec["grad"] = adam_first_grads(prog.optimizer, weights.leaves(prog.params))
    finally:
        train_mod.sample_all_z = sample_all_z
    rec["change"] = changes(weights.leaves(prog.params), weights.leaves(prog.base))
    return rec


def adam_first_grads(optimizer, named: dict) -> dict:
    """Each leaf's first gradient norm, from Adam's state after one step
    (exp_avg = (1 - beta1) g)."""
    out = {}
    for k, p in named.items():
        st = optimizer.state.get(p)
        if st is not None and "exp_avg" in st:
            out[k] = float(torch.linalg.norm(st["exp_avg"].double())) / (1.0 - BETA1)
    return out


def changes(now: dict, start: dict) -> dict:
    return {k: float(torch.linalg.norm((now[k].detach() - start[k]).double())) for k in now}


def reference_steps(cfg: dict, inp: dict, base: dict, rec: dict, dev,
                    control: bool = False) -> dict:
    """The plain reference through the recorded steps (float32, TF32 off;
    ``control``: its bf16 products in float8 and the rest in TF32).  Each
    step runs its own sampler stage, whose z tables are compared with the
    program's, and its grad stage at the program's z tables of that step
    (at its own where they are tables of other rays than the batch's)."""
    tr = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    scene = ref_model.build_scene(inp["opt_model"], inp["seq"]["data"]["entities"],
                                  (tr["barf_s"], tr["barf_e"]), dev)
    mesh = ref_model.mesh_state(*inp["mesh"], dev)
    params = weights.trainable(base)
    main, pose, prop = ref_model.adam_groups(params)
    lr = float(tr["lr"])
    optimizer = torch.optim.Adam([{"params": main, "lr": lr}, {"params": pose, "lr": 0.1 * lr},
                                  {"params": prop,
                                   "lr": float(inp["opt_model"]["proposal"]["lr"])}], eps=1e-8)
    gen = torch.Generator(dev)
    out = {"loss": [], "zs": [], "gen_after": []}
    spe = max(tr["tempo_len"] // tr["batch_size"], 1)
    with ref_mlp.rounding(ref_mlp.round_fp8 if control else None):
        for i, (batch_np, step) in enumerate(zip(rec["batches"], rec["steps"])):
            gen.set_state(rec["gen_before"][i])
            z_in = rec["zs"][i]
            rays = len(batch_np["frame_idx"]) * batch_np["uv"].shape[1]
            if any(z.shape[0] != rays for z in z_in.values()):
                z_in = None
            res = ref_model.train_step(params, scene, _batch_dev(batch_np, dev), mesh, gen,
                                       step, step // spe, optimizer, z_vals=z_in)
            out["loss"].append(res["losses"]["loss"])
            out["zs"].append(res["z_vals"])
            out["gen_after"].append(gen.get_state())
            if i == 0:
                out["grad"] = adam_first_grads(optimizer, weights.leaves(params))
    out["change"] = changes(weights.leaves(params), weights.leaves(base))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out


def readings(got: dict, ref: dict, radius: float) -> tuple:
    """The numbers compared: ``draws`` (steps whose generator state after
    the step differs), ``loss`` (the worst step's relative gap), ``z`` (the
    largest over steps and nodes of a high quantile of the sampler's z
    gaps, in scene radii), ``grad`` and ``change`` (over the leaf groups,
    the largest group's median leaf gap of the first gradient's norm and
    of the change's norm); and, for the record, where each of the last
    three read its worst, and the leaves left out."""
    leaves = compare.counted_leaves(ref["grad"])
    grad, grad_group = compare.group_gap(got["grad"], ref["grad"], leaves)
    change, change_group = compare.group_gap(got["change"], ref["change"], leaves)
    z, z_where = compare.z_gap(got["zs"], ref["zs"], radius)
    values = {
        "draws": float(sum(not torch.equal(a, b)
                           for a, b in zip(got["gen_after"], ref["gen_after"]))),
        "loss": compare.loss_gap(got["loss"], ref["loss"]),
        "z": z,
        "grad": grad,
        "change": change,
    }
    return values, {"z": z_where, "grad": grad_group, "change": change_group,
                    "left_out": sorted(set(ref["grad"]) - set(leaves))}


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    inp = inputs(cell, cfg)
    prog = Program(cell, cfg, inp, seed, dev)
    rec = first_steps(prog, int(cell["compare_steps"]))
    rays_step = cell["frames_per_step"] * cell["rays_per_frame"]
    device.sync(dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = device.peak(dev)
    device.reset_peak(dev)

    result = {"setup_s": setup_s}
    if trace:
        n = int(cell["trace_steps"])
        rs = cfg["model"]["ray_sampler"]
        samples = rs["N_samples"] + 2 + rs["N_samples_extra"]
        with sampler_span(), Traced() as tr:
            for _ in range(n):
                prog.run_step(prog.next_batch()[1])
        phases = prog.timed_phases(n)  # synchronised walls, so outside the trace
        result["trace"] = {"summary": tr.summary, "steps": n, "phases": phases,
                           "step_flops": counts.cell_flops(cfg["model"], "train", rays_step,
                                                           len(prog.scene.node_ids)),
                           "row7_points": len(prog.scene.node_ids) * rays_step * samples}
        attempted = 2 * n
    else:
        start, n = time.perf_counter(), 0
        while time.perf_counter() - start < seconds:
            prog.run_step(prog.next_batch()[1])
            n += 1
        device.sync(dev)
        elapsed = time.perf_counter() - start
        result["train_rays_per_s"] = n * rays_step / elapsed
        attempted = n
    peak = device.peak(dev)
    result["peak_gib"] = peak / 2 ** 30
    result["memory_peak_bytes"] = max(peak, setup_peak)
    result["attempted"] = attempted + len(rec["loss"])
    base = prog.base
    prog.close()
    del prog
    gc.collect()
    device.empty_cache(dev)

    ref = reference_steps(cfg, inp, base, rec, dev)
    values, worst = readings(rec, ref, inp["opt_model"]["scene_bounding_sphere"])
    result["values"], result["worst"] = values, worst
    return result
