"""Gameplay systems: projectile spawn/despawn churn.

The reference's app layer stresses entity lifecycle with projectiles
(launch_projectiles_test/update_projectiles + the Deleting deferred-destroy
marker, ecs.rs:183-237, 412-430). Equivalent here: a reserved slot range in
the instance table; one jitted step integrates motion, expires by TTL
(alive-mask churn = the Deleting path), and spawns into the first dead slot —
all inside the frame's functional update, no host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from renderer_jax.scene.types import Scene


class ProjectileState(NamedTuple):
    velocity: jnp.ndarray  # (K, 3)
    age: jnp.ndarray       # (K,)

    @staticmethod
    def init(capacity: int) -> "ProjectileState":
        return ProjectileState(
            velocity=jnp.zeros((capacity, 3), jnp.float32),
            age=jnp.zeros((capacity,), jnp.float32),
        )


@partial(jax.jit, static_argnames=("base", "capacity"), donate_argnums=(0, 1))
def projectile_step(
    scene: Scene,
    state: ProjectileState,
    base: int,
    capacity: int,
    dt,
    ttl,
    spawn_pos,
    spawn_vel,
    do_spawn,
):
    """One tick: integrate, expire, spawn (at most one per tick, like the
    reference's fire-rate-limited launcher)."""
    inst = scene.instances
    sl = slice(base, base + capacity)
    alive = inst.alive[sl]
    pos = inst.translation[sl]
    vel = state.velocity
    age = state.age

    # integrate + gravity
    vel = jnp.where(alive[:, None], vel + jnp.array([0.0, -9.8, 0.0]) * dt, vel)
    pos = jnp.where(alive[:, None], pos + vel * dt, pos)
    age = jnp.where(alive, age + dt, age)

    # expire (the Deleting path: slots become dead, masked out of culling)
    expired = alive & ((age > ttl) | (pos[:, 1] < -50.0))
    alive = alive & ~expired

    # spawn into the first dead slot
    dead_slot = jnp.argmin(alive)  # first False
    can_spawn = do_spawn & ~jnp.all(alive)
    alive = jnp.where(can_spawn, alive.at[dead_slot].set(True), alive)
    pos = jnp.where(can_spawn, pos.at[dead_slot].set(spawn_pos), pos)
    vel = jnp.where(can_spawn, vel.at[dead_slot].set(spawn_vel), vel)
    age = jnp.where(can_spawn, age.at[dead_slot].set(0.0), age)

    new_inst = inst._replace(
        alive=inst.alive.at[sl].set(alive),
        translation=inst.translation.at[sl].set(pos),
        count=jnp.maximum(inst.count, base + capacity),
    )
    return scene._replace(instances=new_inst), ProjectileState(velocity=vel, age=age)


class ProjectileSystem:
    """Host-side wrapper owning a reserved instance-slot range."""

    def __init__(self, scene: Scene, mesh_id: int, material_id: int, capacity: int = 32):
        self.base = int(scene.instances.count)
        self.capacity = capacity
        n = scene.instances.mesh_id.shape[0]
        if self.base + capacity > n:
            raise ValueError("instance table too small for projectile slots")
        inst = scene.instances
        sl = slice(self.base, self.base + capacity)
        self.scene = scene._replace(
            instances=inst._replace(
                mesh_id=inst.mesh_id.at[sl].set(mesh_id),
                material_id=inst.material_id.at[sl].set(material_id),
                scale=inst.scale.at[sl].set(0.15),
            )
        )
        self.state = ProjectileState.init(capacity)

    def step(self, dt=1 / 60, ttl=3.0, spawn_pos=(0, 1, 0), spawn_vel=(2, 4, 0), spawn=True):
        self.scene, self.state = projectile_step(
            self.scene,
            self.state,
            self.base,
            self.capacity,
            jnp.float32(dt),
            jnp.float32(ttl),
            jnp.asarray(spawn_pos, jnp.float32),
            jnp.asarray(spawn_vel, jnp.float32),
            jnp.bool_(spawn),
        )
        return self.scene

    def alive_count(self) -> int:
        import numpy as np

        sl = slice(self.base, self.base + self.capacity)
        return int(np.asarray(self.scene.instances.alive[sl]).sum())
