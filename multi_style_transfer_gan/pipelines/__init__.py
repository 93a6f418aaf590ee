"""Inference pipelines — the reference's CLI capability surface.

- ``direct``      single image, single style (direct_transform.py)
- ``batch``       folder throughput path (batch_process_images.py)
- ``advanced``    5 named processing variants (advanced_transform.py)
- ``local_style`` region-adaptive segmentation blending (enhanced_local_style.py)
- ``compare``     side-by-side enhanced vs plain CycleGAN (GUI compare tab)
"""

from .model_loader import load_generator, LoadedModel
from .direct import transform_image, test_different_sizes, try_skip_connections
from .batch import batch_process, resolve_engine

__all__ = [
    "load_generator", "LoadedModel",
    "transform_image", "test_different_sizes", "try_skip_connections",
    "batch_process",
    "resolve_engine",
]
