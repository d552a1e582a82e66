"""Generate the committed golden frame set.

Max-quality renders of the bench scene at the bench's PSNR gate poses:
exact full-rate shading, SSAA 2x2 (4 samples/pixel) box-resolved,
trilinear filtering, shadows on — the highest-fidelity configuration this
renderer ships. Committed under assets/golden/ as 8-bit PNGs; bench.py
reports `psnr_vs_golden_db` of each run's shipped shadowed tier against
them, making fidelity a CROSS-ROUND series instead of a self-referential
in-run gate.

Run on a GPU: python scripts/make_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bench import (
    GATE_ANGLES, GOLDEN_DIR, HEIGHT, N_INSTANCES, TRI_CAPACITY, WIDTH,
    make_camera,
)
from renderer_jax.models import sponza_like_scene
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.utils.image import write_png


def main():
    scene = sponza_like_scene(N_INSTANCES)
    cfg = PipelineConfig(
        width=WIDTH,
        height=HEIGHT,
        tri_capacity=TRI_CAPACITY,
        use_pallas=True,
        shading="pbr",
        enable_normal_maps=True,
        ssaa=2,           # 4 samples/pixel, box resolve (max-quality AA)
        aa="none",
        trilinear=True,   # full trilinear (the quality filtering mode)
        shade_rate="full",
    )
    r = Renderer(scene, cfg, outputs=("image",))
    r.set_config(shadows=True)
    r.apply_config_now()

    out_dir = os.path.join(os.path.dirname(__file__), "..", GOLDEN_DIR)
    os.makedirs(out_dir, exist_ok=True)
    r.render(make_camera(GATE_ANGLES[0]))  # compile + shadow-cache warm
    for i, a in enumerate(GATE_ANGLES):
        img = np.clip(np.asarray(r.render(make_camera(a))["image"]), 0.0, 1.0)
        path = os.path.join(out_dir, f"shadowed_pose{i}.png")
        write_png(path, img)
        print(f"wrote {path} ({img.shape[1]}x{img.shape[0]})", flush=True)


if __name__ == "__main__":
    main()
