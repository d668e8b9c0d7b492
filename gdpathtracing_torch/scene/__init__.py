from gdpathtracing_torch.scene.scene import (Scene, SceneBuilder,
                                             scene_from_arrays)
from gdpathtracing_torch.scene.materials import Material

__all__ = ["Scene", "SceneBuilder", "scene_from_arrays", "Material"]
