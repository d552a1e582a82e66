"""The rasterization specification shared by every rasterizer implementation
(numpy reference, plain-JAX, Pallas).

Clipless 2D-homogeneous rasterization (Olano-Greer style)
---------------------------------------------------------
Instead of clipping triangles against the near plane (a dynamic-shape
operation hostile to XLA), coverage is evaluated directly from clip-space
coordinates:

For a triangle with clip positions p_i = (x_i, y_i, z_i, w_i), build the
pixel-homogeneous matrix M whose columns are

    u_i = (px_i * w_i, py_i * w_i, w_i)

where (px, py) is the pixel-space projection:

    px = (x/w + 1)/2 * W          (x_ndc=-1 -> 0, +1 -> W)
    py = (1 - y/w)/2 * H          (y_ndc=+1 -> row 0, top)

so u_i = ((x_i + w_i)/2 * W, (w_i - y_i)/2 * H, w_i) — linear in clip
coordinates, never divided, valid for any sign of w.

Unnormalized barycentrics at pixel center q = (j+.5, i+.5, 1):

    lam = sign(det M) * adj(M) @ q          (3,)

Coverage:   all lam_i >= 0 (with the top-left fill rule on == 0)
            and W := sum_i lam_i * w_i > 0          (rejects behind-camera)
            and 0 <= z_ndc <= 1 (per-pixel near/far)
Depth:      z_ndc = (sum_i lam_i * z_i) / W
Attributes: perspective-correct a = sum_i beta_i a_i, beta = lam / sum(lam)

Facing: det(M) < 0 is FRONT for glTF's CCW-front winding under the y-flip
pixel mapping (FRONT_DET_SIGN). Backface culling rejects det >= 0; two-sided
rendering flips lam for back faces.

Top-left fill rule (y-down pixel space, inside == positive): an edge function
e(x,y) = a*x + b*y + c with e == 0 accepts the pixel iff a > 0, or a == 0 and
b > 0. Shared edges between adjacent triangles evaluate to exactly negated
coefficients, so each boundary pixel is claimed by exactly one triangle
(watertightness; tested in tests/test_raster_ref.py).

Depth-test tie-break: lower triangle id wins at equal depth (determinism).

This file is the spec the reference's GLSL pipeline semantics map onto
(vertex transform + rasterizer fixed function + early-z,
src/shaders/gltf_mesh.vert, depth_pipe.vert).
"""

# det(M) sign that corresponds to a front-facing (glTF CCW) triangle.
FRONT_DET_SIGN = -1.0

# Depth buffer clear value (far plane).
DEPTH_CLEAR = 1.0

# tri_id value for "no triangle" in visibility buffers.
NO_TRIANGLE = -1
