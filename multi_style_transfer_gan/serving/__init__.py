"""Production serving layer (new capability — the reference's only online
surface is the tkinter GUI, gan_login_gui.py).

A micro-batching HTTP server over the same single compiled uint8->uint8
program the batch pipeline uses: requests are decoded to the model canvas,
gathered into fixed-shape batches (padded to ``max_batch`` so the device sees
exactly ONE compiled program), stylized in one device call, and restored
per request. See ``serving.server``.
"""

from .server import MicroBatcher, Overloaded, StyleTransferService, serve

__all__ = ["MicroBatcher", "Overloaded", "StyleTransferService", "serve"]
