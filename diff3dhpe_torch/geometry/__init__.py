from diff3dhpe_torch.geometry.quaternion import qrot, qinverse
from diff3dhpe_torch.geometry.camera import (
    normalize_screen_coordinates,
    image_coordinates,
    world_to_camera,
    camera_to_world,
    project_to_2d,
    project_to_2d_linear,
)
from diff3dhpe_torch.geometry.skeleton import Skeleton

__all__ = [
    "qrot",
    "qinverse",
    "normalize_screen_coordinates",
    "image_coordinates",
    "world_to_camera",
    "camera_to_world",
    "project_to_2d",
    "project_to_2d_linear",
    "Skeleton",
]
