"""vokselis_torch — the PyTorch + CUDA port of vokselis_tpu, for one NVIDIA
H100.

The JAX package ``vokselis_tpu`` stays beside it as the reference. This port
imports torch and numpy only; its hot loops are kernels written by hand for
Hopper (``vokselis_torch/csrc``, bound in :mod:`vokselis_torch.ops.cuda`),
each with a plain-torch version that runs on the CPU. It runs the bonsai
volume's exact, fast (shear-warp) and hybrid renderers through the engine
loop: camera -> kernels -> present -> PNG.
"""

__version__ = "0.1.0"

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.core.config import RenderConfig
from vokselis_torch.core.uniforms import GlobalUniform
from vokselis_torch.utils.grid import dispatch_optimal

__all__ = [
    "Camera",
    "CameraUniform",
    "GlobalUniform",
    "RenderConfig",
    "dispatch_optimal",
    "__version__",
]
