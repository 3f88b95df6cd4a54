"""Render path: per-instance mesh properties (device), octahedron-sphere
particle mesh, orbit camera, and host-side point-sprite frame export.

Replaces the reference's GPU render stack — UpdateMeshProperties.compute →
MeshProperties structured buffer → Graphics.DrawMeshInstancedIndirect with
InstancedIndirectColor.shader — with a jittable properties pass plus
host-side image/mesh export (a headless accelerator has no swapchain; frames are
exported as PNG/PLY/npz instead).
"""

from .meshprops import RenderParams, mesh_properties, speed_colors  # noqa: F401
from .sphere import octahedron_sphere  # noqa: F401
from .camera import OrbitCamera  # noqa: F401
from .export import render_frame_png, save_png, save_ply  # noqa: F401
