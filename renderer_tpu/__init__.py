"""renderer_tpu — a JAX + Pallas rebuild of Renderer II.

The public API mirrors the reference crate root's curated re-export surface
(reference: renderer/src/lib.rs:95-198) in spirit: Scene, Camera,
CoordinateSystem, Mesh, VertexLibrary{Builder,Measurer}, Material +
PbrMaterialParameters + AlphaMode, Renderer, RenderConfig, capacity
constants. Vulkan bring-up types (Instance/PhysicalDevice/Device/Swapchain/
Arenas/Uploader) have no counterpart here — `jax.devices()` and static shape
planning replace them.
"""

from renderer_tpu.core.camera import GLTF, QUAKE, VULKAN, Camera, CoordinateSystem
from renderer_tpu.core.config import RenderConfig
from renderer_tpu.core.constants import (
    MAX_DRAW_CALLS,
    MAX_JOINT_COUNT,
    MAX_MATERIALS,
    MAX_TEXTURES,
)
from renderer_tpu.engine.profiling import Profiler
from renderer_tpu.engine.renderer import Renderer
from renderer_tpu.engine.stats import format_bytes, log_memory_usage, memory_usage
from renderer_tpu.geometry.vertex_library import (
    Mesh,
    VertexLibrary,
    VertexLibraryBuilder,
    VertexLibraryMeasurer,
)
from renderer_tpu.materials.registry import (
    AlphaMode,
    Material,
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
    TextureWrap,
)
from renderer_tpu.assets.gltf_loader import Gltf, load_gltf
from renderer_tpu.scene.scene import Scene

__all__ = [
    "GLTF", "QUAKE", "VULKAN", "Camera", "CoordinateSystem", "RenderConfig",
    "MAX_DRAW_CALLS", "MAX_JOINT_COUNT", "MAX_MATERIALS", "MAX_TEXTURES",
    "Profiler", "Renderer", "Mesh", "VertexLibrary", "VertexLibraryBuilder",
    "VertexLibraryMeasurer", "AlphaMode", "Material", "MaterialRegistry",
    "PbrMaterialParameters", "Texture", "TextureKind", "TextureWrap", "Scene",
    "Gltf", "load_gltf",
    # HBM accounting — the reference's Bytes printer + vram getters
    # (lib.rs:75-95,103-128)
    "format_bytes", "memory_usage", "log_memory_usage",
]

__version__ = "0.1.0"
