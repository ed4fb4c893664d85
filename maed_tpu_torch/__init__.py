"""maed_tpu_torch — the PyTorch + CUDA port of maed_tpu for NVIDIA Hopper.

The JAX package ``maed_tpu`` is the reference this port is held against; the
module layout mirrors it so each counterpart sits at the same relative path:

  ops/      geometry, SMPL, image normalization, and the kernel wrappers
            (``layernorm``: Triton; ``mlp``, ``groupnorm``, ``st_attention``,
            ``attention`` and ``skinning``: CUDA C++)
  models/   ResNetV2 hybrid stem, ViT/STE encoder, KTD decoder, MAED
  utils/    SMPL model files, checkpoints, JAX weights, logging
  core/     config, builder (the entry points), loss, Evaluator, Trainer
  parallel/ the train step and optimizer; data parallelism across processes
            (``dist``: NCCL on the card, gloo on the CPU)
  data/     datasets, augmentations, loaders
  native/   the C++ data path (JPEG decode, crop, normalize), built with g++
  csrc/     CUDA C++ sources, built with nvcc at first use
  kernels/  the build of ``csrc`` and its ctypes bindings, launch counts
  train.py, eval.py   the CLIs (``python -m maed_tpu_torch.train`` / ``.eval``)

The package imports torch and numpy only: never jax, flax, pyyaml, cv2, PIL
or anything of ``maed_tpu`` (joblib only where it is installed), and never
triton at import time (Triton is imported inside the function that launches
its kernel).
"""

__version__ = "0.1.0"
