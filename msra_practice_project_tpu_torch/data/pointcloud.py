"""Oriented point-cloud loading for SDF fitting (port of
``msra_practice_project_tpu/data/pointcloud.py``; numpy, so the synthetic
clouds are bitwise the JAX package's).

The reference loads a .mat file with an N x 6 array 'p' of (position, normal)
rows (siren/train_sdf.py:32).  We accept .mat, .npy or .npz.  The DEM is the
port's copy of matplotlib's sample file (data/sample_data/); scipy is
imported where it is used.
"""

from __future__ import annotations

import os

import numpy as np

from . import SAMPLE_DATA


def load_point_cloud(path: str, key: str = "p") -> np.ndarray:
    """Returns [N, 6] float32 (xyz, normal)."""
    if path.endswith(".mat"):
        import scipy.io
        data = scipy.io.loadmat(path)[key]
    elif path.endswith(".npz"):
        data = np.load(path)[key]
    else:
        data = np.load(path)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2 or data.shape[1] != 6:
        raise ValueError(f"expected [N, 6] point cloud, got {data.shape}")
    return data


def make_synthetic_sphere_cloud(n: int = 20000, radius: float = 0.6,
                                seed: int = 0) -> np.ndarray:
    """Unit-sphere surface samples with outward normals (tests/smoke)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.concatenate([radius * v, v], axis=1).astype(np.float32)


def load_dem_heightfield(extent: float = 0.7, z_scale: float = 0.2):
    """Real-terrain heightfield from the Jacksboro Fault DEM (USGS
    elevation data; the port's copy of matplotlib's sample file, in
    data/sample_data/: a missing file raises).

    Returns (height [H, W], x_lin [W], y_lin [H]): the elevation grid
    normalised so x/y span [-extent, extent] and z spans 2*z_scale centred
    at 0 — a well-conditioned open surface for the SDF pipeline (the same
    oriented-point-cloud contract as the reference's .mat scenes,
    siren/train_sdf.py:32).
    """
    path = os.path.join(SAMPLE_DATA, "jacksboro_fault_dem.npz")
    with np.load(path) as d:
        elev = np.asarray(d["elevation"], dtype=np.float32)
    h, w = elev.shape
    height = (elev - elev.min()) / (elev.max() - elev.min())  # [0, 1]
    height = (height - 0.5) * (2.0 * z_scale)
    x_lin = np.linspace(-extent, extent, w, dtype=np.float32)
    y_lin = np.linspace(-extent, extent, h, dtype=np.float32)
    return height, x_lin, y_lin


def make_dem_cloud(n: int = 60000, seed: int = 0, extent: float = 0.7,
                   z_scale: float = 0.2, closed: bool = False,
                   z_bottom: float = -0.35) -> np.ndarray:
    """[N, 6] oriented point cloud sampled from the real-terrain DEM.

    Surface points (x, y, h(x, y)) at continuous bilinear positions with
    normals from the height gradient: n ∝ (-∂h/∂x, -∂h/∂y, 1).

    With ``closed=True`` the heightfield is closed into a WATERTIGHT solid
    block (DEM top + four vertical skirt sides + flat bottom at
    ``z_bottom``), with outward normals and area-proportional sampling
    across the six faces.  An open sheet is ill-posed for a signed distance
    field — any sign-consistent field must re-cross zero around the sheet
    boundary, which manifests as spurious isosurface sheets; the
    reference's SDF scenes (siren/train_sdf.py:32 .mat shapes) are
    likewise watertight solids.
    """
    from scipy.ndimage import map_coordinates

    height, x_lin, y_lin = load_dem_heightfield(extent, z_scale)
    h, w = height.shape
    gy, gx = np.gradient(height, y_lin, x_lin)
    rng = np.random.default_rng(seed)

    def sample_top(m):
        rows = rng.uniform(0, h - 1, size=m)
        cols = rng.uniform(0, w - 1, size=m)
        coords = np.stack([rows, cols])
        z = map_coordinates(height, coords, order=1)
        gxs = map_coordinates(gx, coords, order=1)
        gys = map_coordinates(gy, coords, order=1)
        x = x_lin[0] + (x_lin[-1] - x_lin[0]) * cols / (w - 1)
        y = y_lin[0] + (y_lin[-1] - y_lin[0]) * rows / (h - 1)
        normal = np.stack([-gxs, -gys, np.ones_like(gxs)], axis=1)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        pos = np.stack([x, y, z], axis=1)
        return np.concatenate([pos, normal], axis=1)

    if not closed:
        return sample_top(n).astype(np.float32)

    # --- watertight solid: area-proportional top/bottom/side allocation ---
    side = 2.0 * extent
    slope = np.sqrt(1.0 + gx**2 + gy**2)
    area_top = side * side * float(slope.mean())
    area_bot = side * side
    # edge height profiles (h(edge) - z_bottom along each boundary)
    edges = {  # name -> (edge height samples, length axis values)
        "x+": (height[:, -1], y_lin), "x-": (height[:, 0], y_lin),
        "y+": (height[-1, :], x_lin), "y-": (height[0, :], x_lin),
    }
    area_sides = {k: side * float((v - z_bottom).mean())
                  for k, (v, _) in edges.items()}
    areas = [area_top, area_bot] + list(area_sides.values())
    total = sum(areas)
    counts = [max(1, int(round(n * a / total))) for a in areas]
    counts[0] += n - sum(counts)  # make the counts sum exactly to n

    parts = [sample_top(counts[0])]
    # bottom: uniform in the footprint, normal (0, 0, -1)
    m = counts[1]
    bx = rng.uniform(-extent, extent, size=m)
    by = rng.uniform(-extent, extent, size=m)
    parts.append(np.concatenate(
        [np.stack([bx, by, np.full(m, z_bottom)], axis=1),
         np.tile([0.0, 0.0, -1.0], (m, 1))], axis=1))
    # four skirt sides: z uniform in [z_bottom, h(edge)], outward normal
    side_normals = {"x+": (1, 0, 0), "x-": (-1, 0, 0),
                    "y+": (0, 1, 0), "y-": (0, -1, 0)}
    for (name, (prof, axis_lin)), m in zip(edges.items(), counts[2:]):
        t = rng.uniform(0, len(prof) - 1, size=m)
        h_edge = map_coordinates(prof.astype(np.float64), t[None], order=1)
        a = axis_lin[0] + (axis_lin[-1] - axis_lin[0]) * t / (len(prof) - 1)
        z = rng.uniform(0.0, 1.0, size=m) * (h_edge - z_bottom) + z_bottom
        fixed = extent if name[1] == "+" else -extent
        if name[0] == "x":
            pos = np.stack([np.full(m, fixed), a, z], axis=1)
        else:
            pos = np.stack([a, np.full(m, fixed), z], axis=1)
        parts.append(np.concatenate(
            [pos, np.tile(side_normals[name], (m, 1))], axis=1))
    return np.concatenate(parts, axis=0).astype(np.float32)
