"""singa_tpu_torch: the PyTorch + CUDA port of singa_tpu for one NVIDIA
H100.

The JAX package ``singa_tpu`` stays beside this one as the reference;
this package imports nothing of it (and never ``jax``). Module layout
and names follow ``singa_tpu`` so each counterpart is easy to find:

  ``device``                  device resolution (cuda unless asked) and
                              the float32 precision settings
  ``ops.attention``           dense attention, and flash attention
                              forward/backward: the CUDA kernels'
                              wrappers and their plain PyTorch versions
  ``ops.paged_attention``     paged attention: the CUDA kernel's wrapper
                              and its plain PyTorch version
  ``ops.nn``, ``ops.activations``, ``ops.distortion``
                              the image nets' ops: convolution, ceil-mode
                              pooling, LRN, dropout, softmax loss,
                              activations, elastic/affine distortion
  ``csrc/``, ``_build``       the CUDA C++ sources and their nvcc build
  ``models.transformer``      the decoder-only LM
  ``serve``                   the paged-KV serving engine, scheduler,
                              block pool and drafters
  ``config``, ``data``        job confs (copies), token and image shards
  ``params``, ``optim``       param init, updaters and LR schedules
  ``layers``, ``graph``       the conf-driven layers and net builder
  ``trainer``, ``main``       the single-device Trainer, npz
                              checkpoints, and the training CLI
  ``tools.serve_bench``       the serving load harness

Ported so far: the single-engine serving path, training of the
conf-driven LM (one device, or data parallel through the int8 ring),
and the reference's MNIST and CIFAR nets (the MLP, LeNet, AlexNet, the
autoencoder). Batch norm and ResNet-50, the RBM, the prefix cache, the
rest of distribution and the fleet come in later slices (ROADMAP.md).
"""

from .device import resolve_device  # noqa: F401
