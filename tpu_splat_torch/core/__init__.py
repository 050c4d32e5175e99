from tpu_splat_torch.core.types import Cameras, GaussianCloud, SfMScene, CameraModel

__all__ = ["Cameras", "GaussianCloud", "SfMScene", "CameraModel"]
