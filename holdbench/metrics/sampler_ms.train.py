"""The sampler stage's wall a step: the port's StepTimer "sampler" phase
(make_train_step(timer=)), which synchronises the device at each phase
end; read in the traced run only."""

KINDS = ("train",)
UNIT = "ms"
LAYER = "sampler stage (holdnet.sample_all_z, nodes, ray_sampler, proposal net)"
MOVES = "train_rays_per_s"


def read(t: dict):
    v = t.get("phases", {}).get("sampler")
    return v * 1e3 if v else None
