from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.types import Ray, HitInfo, ShadingInfo

__all__ = ["Camera", "Ray", "HitInfo", "ShadingInfo"]
