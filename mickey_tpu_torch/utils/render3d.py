"""Offscreen 3D render: perspective z-buffer software rasterizer (numpy),
``mickey_tpu/utils/render3d.py``.

Counterpart of the reference's pyrender/trimesh offscreen render (reference
lib/utils/visualization.py:93-447 — ``generate_camera``,
``create_scene_and_cams``, ``get_render``), without a GL context: a small
perspective-correct z-buffered rasterizer with textured triangles, and a
scene composer producing the same content as the reference's render —

- the two camera frusta with the actual input images textured on their
  image planes and colored frame borders (reference ``generate_camera``,
  visualization.py:93-160);
- the 3D inlier point cloud as screen-space splats color-coded by position
  (reference adds tiny boxes per point, visualization.py:258-264);
- a view camera with yfov = pi/3 placed behind the reference camera with
  optional x/y orbit angles (reference visualization.py:322-349);
- the 2D composite: white template with the bordered, downscaled input
  images on the left, the render on the right, a 'cool'-colormap confidence
  bar and Reference/Destination legend boxes (visualization.py:355-447).

Everything is numpy; the 'cool' colours come from ``utils.colormaps`` (no
matplotlib) and ``cv2`` draws text and resizes. Given the same inputs the
image is the JAX package's, byte for byte.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .colormaps import lookup


class ZBufferRasterizer:
    """Minimal perspective rasterizer: triangles (flat or textured), point
    splats, and wide line segments, into an RGB image with a z-buffer.

    Camera convention: OpenCV (+z forward, +x right, +y down), intrinsics
    from ``yfov`` like pyrender's PerspectiveCamera (visualization.py:345).
    """

    def __init__(self, width: int, height: int, yfov: float = np.pi / 3.0,
                 background: int = 255):
        self.w, self.h = int(width), int(height)
        self.f = (self.h / 2.0) / np.tan(yfov / 2.0)
        self.cx, self.cy = self.w / 2.0, self.h / 2.0
        self.color = np.full((self.h, self.w, 3), background, np.uint8)
        self.depth = np.full((self.h, self.w), np.inf, np.float64)
        self.near = 1e-3
        self._R = np.eye(3)
        self._t = np.zeros(3)

    def set_camera(self, pose_c2w: np.ndarray) -> None:
        """World -> camera from a (4,4) cam2world view pose."""
        R = pose_c2w[:3, :3]
        t = pose_c2w[:3, 3]
        self._R = R.T
        self._t = -R.T @ t

    def _to_cam(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self._R.T + self._t

    def _project(self, pc: np.ndarray):
        z = pc[:, 2]
        u = self.f * pc[:, 0] / z + self.cx
        v = self.f * pc[:, 1] / z + self.cy
        return u, v, z

    # -- triangles ---------------------------------------------------------

    def draw_triangles(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        face_color: Optional[Sequence[float]] = None,
        uvs: Optional[np.ndarray] = None,
        texture: Optional[np.ndarray] = None,
    ) -> None:
        """Rasterize triangles with a z-test. Either a flat ``face_color``
        or a ``texture`` (H,W,3 uint8) sampled at per-vertex ``uvs`` (u right,
        v down, in [0,1]) with perspective-correct interpolation."""
        pc = self._to_cam(np.asarray(vertices, np.float64))
        for fi, face in enumerate(np.asarray(faces, int)):
            tri = pc[face]
            if np.any(tri[:, 2] <= self.near):
                continue  # no near-plane clipping: skip (viz-only renderer)
            u, v, z = self._project(tri)
            lo_x = max(int(np.floor(u.min())), 0)
            hi_x = min(int(np.ceil(u.max())) + 1, self.w)
            lo_y = max(int(np.floor(v.min())), 0)
            hi_y = min(int(np.ceil(v.max())) + 1, self.h)
            if lo_x >= hi_x or lo_y >= hi_y:
                continue
            gx, gy = np.meshgrid(
                np.arange(lo_x, hi_x) + 0.5, np.arange(lo_y, hi_y) + 0.5
            )
            # edge functions -> barycentric in screen space
            x0, y0 = u[0], v[0]
            e1x, e1y = u[1] - x0, v[1] - y0
            e2x, e2y = u[2] - x0, v[2] - y0
            den = e1x * e2y - e1y * e2x
            if abs(den) < 1e-12:
                continue
            px, py = gx - x0, gy - y0
            b1 = (px * e2y - py * e2x) / den
            b2 = (e1x * py - e1y * px) / den
            b0 = 1.0 - b1 - b2
            inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
            if not inside.any():
                continue
            # perspective-correct: interpolate 1/z linearly in screen space
            inv_z = b0 / z[0] + b1 / z[1] + b2 / z[2]
            zpix = 1.0 / np.maximum(inv_z, 1e-12)
            ys, xs = np.nonzero(inside)
            yy, xx = ys + lo_y, xs + lo_x
            zz = zpix[ys, xs]
            closer = zz < self.depth[yy, xx]
            if not closer.any():
                continue
            yy, xx, zz = yy[closer], xx[closer], zz[closer]
            if texture is not None and uvs is not None:
                uv = np.asarray(uvs, np.float64)[face]
                wu = (
                    b0[ys, xs][closer] * uv[0, 0] / z[0]
                    + b1[ys, xs][closer] * uv[1, 0] / z[1]
                    + b2[ys, xs][closer] * uv[2, 0] / z[2]
                ) * zz
                wv = (
                    b0[ys, xs][closer] * uv[0, 1] / z[0]
                    + b1[ys, xs][closer] * uv[1, 1] / z[1]
                    + b2[ys, xs][closer] * uv[2, 1] / z[2]
                ) * zz
                th, tw = texture.shape[:2]
                ti = np.clip((wv * th).astype(int), 0, th - 1)
                tj = np.clip((wu * tw).astype(int), 0, tw - 1)
                col = texture[ti, tj]
            else:
                col = np.asarray(face_color, np.uint8)
            self.depth[yy, xx] = zz
            self.color[yy, xx] = col

    # -- points ------------------------------------------------------------

    def draw_points(
        self,
        pts: np.ndarray,
        colors: np.ndarray,
        size_world: float = 0.01,
        min_px: int = 1,
    ) -> None:
        """Screen-space square splats with z-test; splat radius scales with
        ``size_world`` / depth (the reference adds size_box trimesh boxes,
        visualization.py:258-264)."""
        if len(pts) == 0:
            return
        pc = self._to_cam(np.asarray(pts, np.float64))
        ok = pc[:, 2] > self.near
        pc = pc[ok]
        cols = np.asarray(colors)[ok]
        if cols.dtype != np.uint8:
            cols = np.clip(cols * 255.0 if cols.max() <= 1.0 + 1e-6 else cols,
                           0, 255).astype(np.uint8)
        u, v, z = self._project(pc)
        order = np.argsort(-z)  # far first so near splats overwrite
        for i in order:
            r = max(int(round(self.f * size_world / z[i])), min_px)
            x0, x1 = int(u[i]) - r, int(u[i]) + r + 1
            y0, y1 = int(v[i]) - r, int(v[i]) + r + 1
            if x1 <= 0 or y1 <= 0 or x0 >= self.w or y0 >= self.h:
                continue
            x0, y0 = max(x0, 0), max(y0, 0)
            x1, y1 = min(x1, self.w), min(y1, self.h)
            patch = self.depth[y0:y1, x0:x1]
            m = z[i] < patch
            patch[m] = z[i]
            self.color[y0:y1, x0:x1][m] = cols[i]

    # -- segments ----------------------------------------------------------

    def draw_segment(
        self,
        p0: np.ndarray,
        p1: np.ndarray,
        color: Sequence[int],
        radius_world: float = 0.004,
        samples_per_unit: float = 600.0,
    ) -> None:
        """A 3D line as dense point splats (the reference uses thin trimesh
        cylinders, visualization.py:286)."""
        p0 = np.asarray(p0, np.float64)
        p1 = np.asarray(p1, np.float64)
        n = max(int(np.linalg.norm(p1 - p0) * samples_per_unit), 2)
        ts = np.linspace(0.0, 1.0, n)[:, None]
        pts = p0[None] * (1 - ts) + p1[None] * ts
        cols = np.tile(np.asarray(color, np.uint8)[None], (n, 1))
        self.draw_points(pts, cols, size_world=radius_world, min_px=1)


def _frustum_geometry(pose_c2w: np.ndarray, focal: float, im_hw,
                      cam_size: float = 0.3):
    """Image-plane quad corners (world) for a camera at ``pose_c2w``.

    Mirrors the reference's cone-derived image plane (visualization.py:104-117):
    plane at depth h_im = f * cam_size / H behind the optical center along
    +z (OpenCV), half-extents sized so the plane subtends the image.
    """
    H, W = im_hw
    h_im = focal * cam_size / H
    half_h = cam_size / 2.0
    half_w = half_h * (W / H)
    corners_cam = np.array(
        [
            [-half_w, -half_h, h_im],  # top-left (u=0, v=0)
            [half_w, -half_h, h_im],   # top-right
            [half_w, half_h, h_im],    # bottom-right
            [-half_w, half_h, h_im],   # bottom-left
        ]
    )
    R, t = pose_c2w[:3, :3], pose_c2w[:3, 3]
    return corners_cam @ R.T + t


def _add_camera(
    ras: ZBufferRasterizer,
    pose_c2w: np.ndarray,
    image: np.ndarray,
    focal: float,
    frame_color: Sequence[int],
    cam_size: float = 0.3,
    border_frac: float = 0.035,
) -> np.ndarray:
    """Textured image plane + colored border + frustum edge lines.

    Counterpart of reference ``generate_camera`` (visualization.py:93-160):
    the image is drawn inside the frustum with a colored frame (their
    inv_edge_width=0.93 edge mesh becomes a colored texture border here),
    plus the four rays from the optical center to the plane corners.
    Returns the world-space image-plane corners (used for ray intersections).
    """
    im = np.ascontiguousarray(image)
    if im.dtype != np.uint8:
        im = np.clip(im * 255.0 if im.max() <= 1.0 + 1e-6 else im, 0, 255).astype(np.uint8)
    b = max(int(border_frac * min(im.shape[:2])), 2)
    framed = np.empty((im.shape[0] + 2 * b, im.shape[1] + 2 * b, 3), np.uint8)
    framed[:] = np.asarray(frame_color, np.uint8)
    framed[b:-b, b:-b] = im

    corners = _frustum_geometry(pose_c2w, focal, im.shape[:2], cam_size)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    uvs = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    ras.draw_triangles(corners, faces, uvs=uvs, texture=framed)
    # back face too (reference duplicates reversed faces so the plane is
    # visible from behind, visualization.py:120)
    ras.draw_triangles(corners, faces[:, ::-1], uvs=uvs, texture=framed)

    origin = pose_c2w[:3, 3]
    for c in corners:
        ras.draw_segment(origin, c, frame_color, radius_world=0.0022)
    return corners


def get_render_offscreen(
    pose: np.ndarray,
    image0: np.ndarray,
    image1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    points: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    color_src_frame=(255, 0, 0),
    color_dst_frame=(0, 255, 0),
    cam_size: float = 0.3,
    angle_x: float = 0.0,
    angle_y: float = 0.0,
    cam_offset_z: float = -2.2,
    cam_offset_x: float = 0.0,
    cam_offset_y: float = -0.15,
    size_box: float = 0.008,
    width: int = 1000,
    height: int = 720,
    add_ref_pts: bool = True,
    total_matches: int = 2000,
    max_conf_th: float = 0.8,
    add_confidence: bool = True,
) -> np.ndarray:
    """Full composite render, reference ``get_render`` equivalent
    (visualization.py:200-447).

    pose: (4,4) world2cam relative pose T_0to1 (the model output); the
    destination camera is placed at inv(pose) like the reference
    (visualization.py:236). images are (H,W,3) in [0,1] or uint8.
    """
    import cv2

    ras = ZBufferRasterizer(width, height, yfov=np.pi / 3.0)

    # view camera behind the reference camera, orbiting the midpoint of the
    # two camera centers (reference rotates about `center`,
    # visualization.py:322-342)
    pose_c2w = np.linalg.inv(pose)
    center = 0.5 * pose_c2w[:3, 3]
    cam_pose = np.eye(4)
    cam_pose[:3, 3] = [cam_offset_x, cam_offset_y, cam_offset_z]

    def _rot(axis, deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        if axis == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    for axis, deg in (("y", angle_y), ("x", angle_x)):
        if deg:
            R = _rot(axis, deg)
            cam_pose[:3, :3] = R @ cam_pose[:3, :3]
            cam_pose[:3, 3] = R @ (cam_pose[:3, 3] - center) + center
    ras.set_camera(cam_pose)

    f0 = float((K0[0, 0] + K0[1, 1]) / 2.0)
    f1 = float((K1[0, 0] + K1[1, 1]) / 2.0)
    plane0 = _add_camera(ras, np.eye(4), image0, f0, color_src_frame, cam_size)
    _add_camera(ras, pose_c2w, image1, f1, color_dst_frame, cam_size)

    if points is not None and len(points):
        pcols = colors if colors is not None else np.full((len(points), 3), 0.35)
        ras.draw_points(np.asarray(points), np.asarray(pcols), size_world=size_box)
        if add_ref_pts:
            # project each 3D point onto the reference image plane along the
            # ray from the reference optical center (visualization.py:271-294)
            n = np.cross(plane0[1] - plane0[0], plane0[2] - plane0[0])
            d = float(n @ plane0[0])
            pts = np.asarray(points, np.float64)
            denom = pts @ n
            ok = np.abs(denom) > 1e-9
            ts = np.where(ok, d / np.where(ok, denom, 1.0), 0.0)
            hits = pts * ts[:, None]
            vis = ok & (ts > 0) & (ts < 1)
            pc2 = np.asarray(pcols)[vis]
            ras.draw_points(hits[vis], pc2, size_world=size_box * 0.6)

    render_3d = ras.color

    # --- 2D composite (visualization.py:355-447) ---------------------------
    def _to_u8(im):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = np.clip(im * 255.0 if im.max() <= 1.0 + 1e-6 else im, 0, 255).astype(np.uint8)
        return im

    border = 15
    img0 = cv2.copyMakeBorder(
        _to_u8(image0), border, border, border, border,
        cv2.BORDER_CONSTANT, value=tuple(int(c) for c in color_src_frame),
    )
    img1 = cv2.copyMakeBorder(
        _to_u8(image1), border, border, border, border,
        cv2.BORDER_CONSTANT, value=tuple(int(c) for c in color_dst_frame),
    )
    factor_down = 2.5
    new_size = (int(img0.shape[1] / factor_down), int(img0.shape[0] / factor_down))
    img0 = cv2.resize(img0, new_size, interpolation=cv2.INTER_LINEAR)
    img1 = cv2.resize(img1, new_size, interpolation=cv2.INTER_LINEAR)

    offset = (render_3d.shape[0] - 2 * new_size[1] - 50) // 2
    offset_w = 100
    template = np.full(
        (render_3d.shape[0], render_3d.shape[1] + new_size[0] + offset_w, 3),
        255, np.uint8,
    )
    template[:, new_size[0] + offset_w:] = render_3d
    template[offset:offset + new_size[1], 20:20 + new_size[0]] = img0
    template[50 + offset + new_size[1]:50 + offset + 2 * new_size[1],
             20:20 + new_size[0]] = img1

    if add_confidence:
        n_pts = 0 if points is None else len(points)
        conf_pose = min(n_pts / (total_matches * max_conf_th), 1.0)
        hb, wb = 30, 200
        ramp = (wb - np.arange(wb)) / wb
        bar = lookup("cool", np.tile(ramp, (hb, 1)))[:, :, :3]
        bar[:, int(wb * conf_pose):] = 255
        bar[:2], bar[-2:], bar[:, :2], bar[:, -2:] = 0, 0, 0, 0
        y1 = 50 + offset + 2 * new_size[1]
        x0 = 20 + new_size[0] + 50
        template[y1 - hb:y1, x0:x0 + wb] = bar
        cv2.putText(template, "Confidence", (x0, y1 - hb - 5),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 0), 2)

    for label, color, row in (
        ("Reference", color_src_frame, 3),
        ("Destination", color_dst_frame, 2),
    ):
        hb, wb = 20, 35
        box = np.full((hb, wb, 3), 255, np.uint8)
        box[:] = np.asarray(color, np.uint8)
        box[:2], box[-2:], box[:, :2], box[:, -2:] = 0, 0, 0, 0
        y1 = 50 + offset + 2 * new_size[1] - 40 * row
        x0 = 20 + new_size[0] + 50
        template[y1 - hb:y1, x0:x0 + wb] = box
        cv2.putText(template, label, (x0 + wb + 10, y1),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 0), 2)

    return template
