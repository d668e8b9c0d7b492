from gdpathtracing_torch.diff.inverse import (image_mse, render_loss,
                                              replace_albedo,
                                              replace_camera_transform,
                                              replace_emission,
                                              replace_instance_transforms,
                                              replace_textures,
                                              replace_vertices,
                                              unbiased_mse_value_and_grad,
                                              value_and_grad_step)

__all__ = [
    "image_mse", "render_loss", "unbiased_mse_value_and_grad",
    "value_and_grad_step", "replace_albedo", "replace_emission",
    "replace_vertices", "replace_instance_transforms", "replace_textures",
    "replace_camera_transform",
]
