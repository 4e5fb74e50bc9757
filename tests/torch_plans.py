"""How the port's tests reach its plain paths on nets the kernels take.

``build_scene`` chooses each node's path from its nets and the device: the
fused query and the fused shade where the kernels take the nets, the
layer-by-layer sampler and the chunked shade elsewhere.  A test that holds
a plain path on supported nets replaces the scene's plans."""


def with_plans(scene, **fields):
    """``scene`` with every node's plans given ``fields``
    (``NodePlans._replace``), e.g. ``fused_query=False`` for the
    layer-by-layer sampler, ``fused_shade=False`` for the chunked shade,
    ``shade_bf16=True`` for its bf16 products on the CPU."""
    scene.plans = {nid: p._replace(**fields) for nid, p in scene.plans.items()}
    return scene
