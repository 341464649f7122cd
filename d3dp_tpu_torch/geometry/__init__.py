from d3dp_tpu_torch.geometry.camera import (
    camera_to_world,
    image_coordinates,
    normalize_screen_coordinates,
    project_to_2d,
    project_to_2d_linear,
    uvd2xyz,
    world_to_camera,
)
from d3dp_tpu_torch.geometry.quaternion import qinverse, qrot

__all__ = [
    "camera_to_world", "image_coordinates", "normalize_screen_coordinates",
    "project_to_2d", "project_to_2d_linear", "uvd2xyz", "world_to_camera",
    "qinverse", "qrot",
]
