"""Core math: camera, global uniforms, ray geometry, color transforms, config."""

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.core.config import RenderConfig
from vokselis_torch.core.uniforms import GlobalUniform

__all__ = ["Camera", "CameraUniform", "GlobalUniform", "RenderConfig"]
