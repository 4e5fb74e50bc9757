"""Faults planted in the program underneath a run, for the checks that
must come out false: in the CPU tests at toy widths, and in
``calibrate.py`` at a cell's own size on the card.  Each patches the
port's module attribute that the entries look up when they build or run
the program, and ``planted`` undoes it."""

from __future__ import annotations

import contextlib

import torch


def _unchanged(train_mod, render_mod):
    """A training step that returns its state unchanged (Adam's step does
    nothing)."""
    orig = train_mod.make_train_step

    def make(scene, optimizer, timer=None, split=None):
        optimizer.step = lambda *a, **k: None
        return orig(scene, optimizer, timer, split)

    return train_mod, "make_train_step", make


def _half_batch(train_mod, render_mod):
    """A training step on the first half of the batch's frames, its mean
    over those rays alone."""
    orig = train_mod.make_train_step

    def make(scene, optimizer, timer=None, split=None):
        step = orig(scene, optimizer, timer, split)

        def half(params, batch, *rest):
            B, P = batch["uv"].shape[:2]
            b = B // 2
            cut = {k: (v[:b * P] if k in ("gt_rgb", "gt_mask") else
                       v[:b] if torch.is_tensor(v) and v.dim() > 0 else v)
                   for k, v in batch.items()}
            return step(params, cut, *rest)
        return half

    return train_mod, "make_train_step", make


def _pose_grad(train_mod, render_mod):
    """A training step whose first hand's pose and shape gradients reach
    Adam at 0.8 times their value (a backward that drops a term of rows
    2-3), every other leaf's as it was."""
    orig = train_mod.make_train_step

    def make(scene, optimizer, timer=None, split=None):
        step = orig(scene, optimizer, timer, split)
        adam_step = optimizer.step
        hand = scene.node_ids[0]

        def scaled(params, *rest):
            tables = [t for t in params[hand]["tables"].values() if t.requires_grad]

            def step_scaled(*a, **k):
                for t in tables:
                    if t.grad is not None:
                        t.grad.mul_(0.8)
                return adam_step(*a, **k)

            optimizer.step = step_scaled
            try:
                return step(params, *rest)
            finally:
                optimizer.step = adam_step
        return scaled

    return train_mod, "make_train_step", make


def _proposal_offset(train_mod, render_mod):
    """The sampler's proposal query off by 5 % of the scene's radius on one
    ray in ten (a fault of a fused proposal query on some of its tiles)."""
    import hold_tpu_torch.models.nodes as nodes_mod

    orig = nodes_mod._proposal_query_z

    def make(nparams, plans, *a, **k):
        query_z = orig(nparams, plans, *a, **k)
        off = 0.05 * plans.sampler.scene_bounding_sphere

        def shifted(z_RS):
            sdf = query_z(z_RS).clone()
            sdf[::10] += off
            return sdf
        return shifted

    return nodes_mod, "_proposal_query_z", make


def _altered_answer(train_mod, render_mod):
    """A rendered chunk whose colour is altered where it is made."""
    orig = render_mod.make_chunk_renderer

    def make(scene, timer=None):
        chunk = orig(scene, timer)

        def altered(*a, **k):
            out = chunk(*a, **k)
            out["rgb"] = out["rgb"] + 0.05
            return out
        return altered

    return render_mod, "make_chunk_renderer", make


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "pose_grad": _pose_grad,
          "proposal_offset": _proposal_offset, "altered_answer": _altered_answer}


@contextlib.contextmanager
def planted(name: str):
    import hold_tpu_torch.render.renderer as render_mod
    import hold_tpu_torch.train as train_mod

    mod, attr, new = FAULTS[name](train_mod, render_mod)
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    try:
        yield
    finally:
        setattr(mod, attr, old)
