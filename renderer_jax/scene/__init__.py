"""Scene substrate: structure-of-arrays pytrees resident in HBM.

The reference keeps scene state in a bevy_ecs world (components at
src/ecs/components.rs, consolidated mesh megabuffers at
src/renderer/systems/consolidate_mesh_buffers.rs). Here the whole scene is a
set of fixed-capacity SoA pytrees so every per-entity "system" becomes one
batched array computation inside the jitted frame program.
"""

from renderer_jax.scene.types import (  # noqa: F401
    MeshLibrary,
    Instances,
    Materials,
    Lights,
    Scene,
    SceneLimits,
)
from renderer_jax.scene.builder import SceneBuilder  # noqa: F401
