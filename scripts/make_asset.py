"""Generate the committed GLB asset (assets/colonnade.glb).

The reference loads its scene from disk at startup (main.rs:337-351);
renderer_jax's external-asset path is the from-scratch GLB parser/writer
(scene/gltf.py). This writes the colonnade spec once; the file is committed
and tests/test_asset_glb.py asserts it renders identically to the
procedural twin (models/scenes.colonnade_scene).

Usage: python scripts/make_asset.py [out.glb]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from renderer_jax.models.scenes import colonnade_spec
from renderer_jax.scene.gltf import write_glb


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "assets", "colonnade.glb"
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    meshes, instances, materials = colonnade_spec()
    write_glb(out, meshes, instances=instances, materials=materials)
    print(f"wrote {out}: {os.path.getsize(out)} bytes, "
          f"{len(meshes)} meshes, {len(instances)} instances")


if __name__ == "__main__":
    main()
