"""Pallas kernels for the hot ops (GPU, Triton route)."""

from .window_attention import window_channel_attention

__all__ = ["window_channel_attention"]
