"""Core linear algebra for the renderer: quaternions, TRS matrices, cameras.

Replaces the reference's nalgebra usage (e.g. src/ecs.rs:52-181
model_matrix_calculation, ecs/camera_controller.rs) with batched jnp matmuls.

Conventions
-----------
- Matrices are 4x4, column-vector convention: ``p' = M @ [p, 1]``.
  Batched points are transformed as ``pts_h @ M.T``.
- Quaternions are ``(w, x, y, z)``.
- Camera looks down -Z in view space, +Y up.
- Clip space: after perspective divide, x,y in [-1, 1], depth z in [0, 1]
  (Vulkan-style depth range; the reference renders with VK depth semantics).
- The viewport transform maps NDC y=+1 to image row 0 (top).
"""

from renderer_jax.mathx.transforms import (  # noqa: F401
    quat_identity,
    quat_from_axis_angle,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat3,
    trs_matrix,
    compose_model_matrices,
    transform_points,
    transform_aabb,
)
from renderer_jax.mathx.camera import (  # noqa: F401
    Camera,
    look_at,
    perspective,
    view_matrix,
    frustum_planes,
    aabb_outside_frustum,
)
