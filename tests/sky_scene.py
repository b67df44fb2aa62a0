"""Sky-lit test scenes for the port's environment-map tests.

`write_sky_floor` writes the JAX package's sky-lit floor scene
(tests/test_env_scene.py): a 16x32 Radiance sky with a warm sun texel, a
10x10 floor and one quad light, optionally with a `Direction` light, a
back wall (so that paths bounce more than once, which training needs) or
without the sky; the sky's background is drawn from a numpy seed. The sky
is written with the port's `write_hdr` (new-RLE or flat scanlines), which
both packages' loaders read.
"""
import os

import numpy as np

from spcbpt_tpu_torch.scene.hdr import write_hdr

SKY_H, SKY_W = 16, 32
SUN = (13, 8)                  # texel of the sun: high rows look up
SUN_RGB = (200.0, 180.0, 150.0)
DIRECTION_BLOCK = """
light
{
    direction 0.3 -1.0 0.4
    emission 3 2.5 2
    type Direction
}
"""


def sky_raster(seed: int = 0, h: int = SKY_H, w: int = SKY_W):
    """A (h, w, 3) float32 sky: a blue-to-white gradient with noise from
    `seed`, and the sun texel."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float32)[:, None, None] + 0.5) / h
    base = 0.02 + 0.06 * v * np.array([0.6, 0.8, 1.0], np.float32)
    rgb = base + rng.uniform(0.0, 0.02, (h, w, 3)).astype(np.float32)
    rgb[SUN[0] * h // SKY_H, SUN[1] * w // SKY_W] = SUN_RGB
    return rgb.astype(np.float32)


WALL_BLOCK = """
mesh
{
    file env/wall.obj
    material White
}
"""


def write_sky_floor(root: str, seed: int = 0, direction: bool = False,
                    sky: bool = True, rle: bool = False,
                    env_lum: float = 1.0, wall: bool = False) -> str:
    """Writes the scene under `root`; returns the .scene path."""
    d = os.path.join(root, "env")
    os.makedirs(d, exist_ok=True)
    write_hdr(os.path.join(d, "sky.hdr"), sky_raster(seed), rle=rle)
    with open(os.path.join(d, "floor.obj"), "w") as f:
        f.write("v -5 0 -5\nv -5 0 5\nv 5 0 5\nv 5 0 -5\nf 1 2 3\nf 1 3 4\n")
    with open(os.path.join(d, "wall.obj"), "w") as f:    # facing -z
        f.write("v -5 0 5\nv -5 5 5\nv 5 5 5\nv 5 0 5\nf 1 2 3\nf 1 3 4\n")
    env = f"    env_file env/sky.hdr\n    env_lum {env_lum}\n" if sky else ""
    # mesh and sky paths are relative to the scene directory's parent
    path = os.path.join(d, "scene.scene")
    with open(path, "w") as f:
        f.write(f"""
properties
{{
    width 48
    height 48
}}
cameraSetting
{{
    eye 0 3 -8
    lookat 0 1 0
    fov 45
{env}}}
material White
{{
    color 0.7 0.7 0.7
    roughness 0.6
    metallic 0.0
}}
light
{{
    position -0.5 4.0 -0.5
    v1 0.5 4.0 -0.5
    v2 -0.5 4.0 0.5
    emission 5 5 5
    type Quad
    divLevel 4
}}
{DIRECTION_BLOCK if direction else ""}{WALL_BLOCK if wall else ""}
mesh
{{
    file env/floor.obj
    material White
}}
""")
    return path
