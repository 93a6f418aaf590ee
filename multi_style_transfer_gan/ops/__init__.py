"""On-device image frontend and classical-CV ops (jnp / Pallas).

The reference does all of this per-image on the host with PIL/OpenCV/scipy
(batch_process_images.py:186-238, 304-406; improved_smooth.py;
advanced_transform.py:130-311). Here the hot-path ops are batched,
static-shape jnp so they fuse into the model's XLA program and the device
never waits on the host; cv2 remains available host-side as a verification oracle.
"""

from .image import (
    normalize_to_unit, denormalize_from_unit, to_model_range, from_model_range,
    resize, canvas_paste, resize_center_crop, aspect_crop_bounds, restore_aspect,
)

__all__ = [
    "normalize_to_unit", "denormalize_from_unit",
    "to_model_range", "from_model_range",
    "resize", "canvas_paste", "resize_center_crop", "aspect_crop_bounds", "restore_aspect",
]
