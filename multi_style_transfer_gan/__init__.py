"""multi_style_transfer_gan — a JAX style-transfer GAN framework.

A ground-up JAX/XLA/Pallas rebuild of the capability surface of the reference
project ``regicide211212/multi-style-transfer-gan`` (a PyTorch Monet<->photo
CycleGAN application; see SURVEY.md):

- ``core``      — NN building blocks with PyTorch-compatible numerics
                  (conv / conv-transpose / instance- & batch-norm / spectral
                  norm / activations), NHWC layout, bf16-friendly.
- ``models``    — the model zoo: plain encoder-decoder CycleGAN generator,
                  the enhanced attention/transformer generator, the two-headed
                  discriminator (reference: enhanced_generator.py, pretrain.py).
- ``ops``       — image frontend + classical-CV ops in jnp (resize, canvas
                  paste, color spaces, filters, edges, histogram ops) and
                  the fused Pallas-Triton LocalAttention kernel for the GPU.
- ``parallel``  — mesh/sharding utilities: data-parallel over the devices,
                  optional spatial sharding for large images.
- ``data``      — host-side dataset with async device prefetch (the reference
                  has a serial batch=1 loop; we batch + pipeline).
- ``train``     — masked-inpainting pretraining and CycleGAN training
                  (MSE-GAN + cycle/identity/structure losses) as pjit-able
                  pure functions, optax optimizers, checkpointing.
- ``pipelines`` — direct / batch / advanced(5-variant) / local-style /
                  compare inference pipelines (reference CLI surface).
- ``metrics``   — SSIM / PSNR / MSE / FID and Excel+chart reporting.
- ``weights``   — PyTorch ``.pth`` checkpoint import/export and conversion
                  (reference: convert_model.py, pth_info.py).
- ``cli``       — flag-compatible command-line entry points.
"""

__version__ = "0.1.0"
