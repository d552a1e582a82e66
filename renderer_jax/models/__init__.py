"""Scene families: the BASELINE.md milestone ladder as reproducible builders
(Box -> textured PBR -> skinned -> Sponza-class instanced scenes). The glTF
sample assets are not vendored in this environment, so each family is
generated procedurally at equivalent complexity and can round-trip through
scene/gltf.py."""

from renderer_jax.models.scenes import (  # noqa: F401
    box_scene,
    textured_scene,
    sponza_like_scene,
)
