"""The in-repo flagship scene and its generated bitmap textures.

``scenes/flagship.sdl`` follows the layout of the reference's lecture5
scene (a floor plane and a globe with bitmap textures, a CsgDiff cube minus
sphere, three Phong spheres on translated nodes) plus a Reflection-shaded
mirror sphere, at 1920x1080, maxTraceDepth 5, AA on.  Its two bitmaps are
not stored: :func:`ensure_flagship_textures` draws them from a fixed seed
with numpy and writes them with the repo's own BMP writer into
``scenes/textures/`` (git-ignored).  The call is idempotent and cheap when
the files already exist, so every entry point makes it before loading the
scene.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

SCENES_DIR = pathlib.Path(__file__).resolve().parents[2] / "scenes"
FLAGSHIP_SCENE = SCENES_DIR / "flagship.sdl"
TEXTURE_DIR = SCENES_DIR / "textures"
TEXTURE_SEED = 20140923

# (file name, height, width) — the globe is an equirectangular 2:1 map
GLOBE = ("world.bmp", 1024, 2048)
FLOOR = ("floor.bmp", 1024, 1024)


def _periodic_noise(rng, h: int, w: int, cells: int, octaves: int) -> np.ndarray:
    """Fractal value noise in [0, 1] that wraps in both axes (textures are
    sampled with edge wrap).  Octave k has cells * 2**k lattice cells
    across the width and bilinear smoothstep interpolation between them."""
    out = np.zeros((h, w), np.float64)
    total = 0.0
    for k in range(octaves):
        cx = cells * 2**k
        cy = max(1, cx * h // w)
        lattice = rng.random((cy, cx))
        fy = np.arange(h) * cy / h
        fx = np.arange(w) * cx / w
        y0 = np.floor(fy).astype(int)
        x0 = np.floor(fx).astype(int)
        ty = fy - y0
        tx = fx - x0
        ty = ty * ty * (3 - 2 * ty)
        tx = tx * tx * (3 - 2 * tx)
        y1, x1 = (y0 + 1) % cy, (x0 + 1) % cx
        top = lattice[y0][:, x0] * (1 - tx) + lattice[y0][:, x1] * tx
        bot = lattice[y1][:, x0] * (1 - tx) + lattice[y1][:, x1] * tx
        amp = 0.5**k
        out += amp * (top * (1 - ty[:, None]) + bot * ty[:, None])
        total += amp
    return out / total


def globe_texture(seed: int = TEXTURE_SEED) -> np.ndarray:
    """Linear RGB [1024, 2048, 3] planet map: oceans, continents, ice caps."""
    _, h, w = GLOBE
    rng = np.random.default_rng(seed)
    height = _periodic_noise(rng, h, w, 4, 7)
    moisture = _periodic_noise(rng, h, w, 8, 4)
    lat = np.abs(np.linspace(-1.0, 1.0, h))[:, None] * np.ones((1, w))
    land = height > 0.52
    depth = np.clip((0.52 - height) / 0.2, 0.0, 1.0)[..., None]
    ocean = (1 - depth) * np.array([0.05, 0.25, 0.45]) + depth * np.array([0.01, 0.04, 0.15])
    green = np.array([0.10, 0.35, 0.08])
    desert = np.array([0.55, 0.45, 0.25])
    m = np.clip(moisture * 1.6 - 0.3, 0.0, 1.0)[..., None]
    ground = m * green + (1 - m) * desert
    rgb = np.where(land[..., None], ground, ocean)
    ice = (lat + 0.08 * (moisture - 0.5)) > 0.85
    rgb = np.where(ice[..., None], np.array([0.85, 0.88, 0.92]), rgb)
    return rgb.astype(np.float32)


def floor_texture(seed: int = TEXTURE_SEED + 1) -> np.ndarray:
    """Linear RGB [1024, 1024, 3] stone tiles: 8x8 tiles of two tones with
    grain noise and dark grout lines."""
    _, h, w = FLOOR
    rng = np.random.default_rng(seed)
    grain = _periodic_noise(rng, h, w, 16, 5)
    yy, xx = np.mgrid[0:h, 0:w]
    tile = w // 8
    parity = ((yy // tile) + (xx // tile)) % 2
    light = np.array([0.62, 0.58, 0.50])
    dark = np.array([0.22, 0.20, 0.18])
    base = np.where(parity[..., None] == 0, light, dark)
    rgb = base * (0.75 + 0.5 * grain[..., None])
    grout = (np.minimum(yy % tile, xx % tile) < 6)[..., None]
    rgb = np.where(grout, np.array([0.08, 0.08, 0.08]), rgb)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def _write_atomic(path: pathlib.Path, rgb: np.ndarray) -> None:
    from ..imageio.bmp import save_bmp_file

    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    save_bmp_file(str(tmp), rgb)
    os.replace(tmp, path)  # concurrent writers produce identical bytes


def ensure_flagship_textures() -> pathlib.Path:
    """Generate the flagship scene's bitmaps if they are missing; returns
    the texture directory."""
    TEXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for (name, h, w), make in ((GLOBE, globe_texture), (FLOOR, floor_texture)):
        path = TEXTURE_DIR / name
        # 24-bpp BMP: 54-byte header + rows padded to 4 bytes
        if not path.exists() or path.stat().st_size != 54 + h * (-(-w * 3 // 4) * 4):
            _write_atomic(path, make())
    return TEXTURE_DIR


def flagship_scene_path() -> str:
    """Path of ``scenes/flagship.sdl``, with its textures in place."""
    ensure_flagship_textures()
    return str(FLAGSHIP_SCENE)


def load_flagship(width: int = None, height: int = None, aa: bool = None):
    """Parse the flagship scene, optionally resized (the camera follows the
    frame size) or with AA switched."""
    from .loader import parse_scene_from_file

    sc = parse_scene_from_file(flagship_scene_path())
    if width is not None:
        sc.settings.frameWidth, sc.settings.frameHeight = width, height
        sc.camera.set_frame_size(width, height)
    if aa is not None:
        sc.settings.AAEnabled = aa
    return sc


def load_flagship_gi(width: int, height: int, paths: int = 40):
    """The flagship scene as a path-tracing (GI) scene: the mirror ball goes
    (Reflection has no GI BRDF) and the Phong shaders become Lambert ones of
    the same color (the reference's Phong has no GI BRDF either and paints
    a path that samples it red); 1 sample per pixel (AA off), depth 5."""
    from ..models import types as T

    sc = load_flagship(width, height, aa=False)
    sc.nodes = [n for n in sc.nodes if not isinstance(n.shader, T.Reflection)]
    for n in sc.nodes:
        if isinstance(n.shader, T.Phong):
            n.shader = T.Lambert(name=n.shader.name, color=n.shader.color)
    sc.shaders = list({id(n.shader): n.shader for n in sc.nodes}.values())
    sc.settings.GIEnabled = True
    sc.settings.maxTraceDepth = 5
    sc.settings.pathsPerPixel = paths
    return sc


def reference_scene(name: str) -> str:
    """Path of one of the reference's own scene files (lecture4.sdl,
    zaphod.sdl, ...) in the Chess2RT ``data/`` checkout that
    ``CHESS2RT_DATA_DIR`` names; those files are not part of this repo."""
    data_dir = os.environ.get("CHESS2RT_DATA_DIR")
    if not data_dir:
        raise FileNotFoundError(
            f"{name} is a reference scene: set CHESS2RT_DATA_DIR to a Chess2RT data/ checkout"
        )
    return os.path.join(data_dir, name)
