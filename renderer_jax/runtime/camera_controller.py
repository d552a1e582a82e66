"""Fly-mode camera controller (input-layer parity).

The reference drives its camera from winit key/mouse events
(ecs/camera_controller.rs:37-77: WASD + mouse-look with a fly-mode toggle;
ecs/input.rs press/hold sets). This renderer is headless, so the controller
is a pure function of (state, per-frame input) — the same math, consumable by
any event source (scripted demos, a future viewer, replay files).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraState:
    position: np.ndarray
    yaw: float = 0.0    # radians about +Y
    pitch: float = 0.0  # radians about camera X, clamped
    fly_mode: bool = True  # False = locked to a ground height (walk mode)
    ground_y: float = 0.0


@dataclasses.dataclass
class InputFrame:
    """One frame's inputs (the InputActions hold-set analogue)."""

    forward: float = 0.0   # +1 = W, -1 = S
    strafe: float = 0.0    # +1 = D, -1 = A
    up: float = 0.0        # +1 = Space, -1 = Ctrl (fly mode only)
    look_dx: float = 0.0   # mouse delta, radians
    look_dy: float = 0.0
    speed: float = 3.0     # units/second
    toggle_fly: bool = False


def step(state: CameraState, inp: InputFrame, dt: float) -> CameraState:
    """Advance the controller one frame; returns a new state."""
    yaw = state.yaw - inp.look_dx
    pitch = float(np.clip(state.pitch - inp.look_dy, -1.55, 1.55))
    fly = state.fly_mode ^ inp.toggle_fly

    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # camera forward (-Z rotated by yaw/pitch), right (+X rotated by yaw)
    forward = np.array([-sy * cp, sp, -cy * cp], np.float32)
    right = np.array([cy, 0.0, -sy], np.float32)
    if not fly:
        # walk mode: motion stays in the ground plane
        flat = np.array([-sy, 0.0, -cy], np.float32)
        move = flat * inp.forward + right * inp.strafe
    else:
        move = forward * inp.forward + right * inp.strafe
        move = move + np.array([0.0, 1.0, 0.0], np.float32) * inp.up
    n = np.linalg.norm(move)
    if n > 1.0:
        move = move / n
    position = state.position + move * (inp.speed * dt)
    if not fly:
        position = position.copy()
        position[1] = state.ground_y
    return CameraState(
        position=position, yaw=yaw, pitch=pitch, fly_mode=fly,
        ground_y=state.ground_y,
    )


def to_camera(state: CameraState, fov_y=0.9, aspect=1.0, near=0.1, far=100.0):
    """CameraState -> renderer_jax Camera (quat from yaw/pitch)."""
    import jax.numpy as jnp

    from renderer_jax import mathx
    from renderer_jax.mathx.camera import Camera

    rot = mathx.quat_mul(
        mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), state.yaw),
        mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), state.pitch),
    )
    return Camera.create(
        position=jnp.asarray(state.position, jnp.float32),
        rotation=rot, fov_y=fov_y, aspect=aspect, near=near, far=far,
    )
