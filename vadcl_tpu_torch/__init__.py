"""vadcl_tpu_torch — the PyTorch + CUDA port of ``vadcl_tpu`` for NVIDIA Hopper.

The JAX package ``vadcl_tpu`` is the reference; this package runs the same
model, training and scoring protocol with PyTorch on an H100, and every
Pallas kernel on those paths is a hand-written CUDA kernel under ``csrc/``.

Subpackages (same names as in ``vadcl_tpu`` so counterparts are easy to find)
-----------------------------------------------------------------------------
core      config dataclasses and presets, dtype policy
ops       window/conv/cluster primitives and the CUDA kernel wrappers
models    nn.Modules: Swin3D encoder/decoder, cluster heads, VADModel
train     loss, gated torch optimizers, train step, checkpoints, epoch loop
eval      PSNR -> anomaly score -> per-scene AUROC, sliding-window scorer
convert   weight bridge from/to the JAX package's flat parameter dict

This package imports torch and numpy, never jax/flax (and not PIL).
"""

__version__ = "0.1.0"
