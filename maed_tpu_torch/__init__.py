"""maed_tpu_torch — the PyTorch + CUDA port of maed_tpu for NVIDIA Hopper.

The JAX package ``maed_tpu`` is the reference this port is held against; the
module layout mirrors it so each counterpart sits at the same relative path:

  ops/      geometry, SMPL, image normalization and the on-device crop, and
            the kernel wrappers (``layernorm``: Triton; ``mlp``,
            ``groupnorm``, ``st_attention``, ``attention`` and ``skinning``:
            CUDA C++), each kernel also a registered operator (``library``)
  models/   ResNetV2 hybrid stem, ViT/STE encoder, KTD decoder, MAED
  utils/    SMPL model files, checkpoints, JAX weights, logging, export
  core/     config, builder (the entry points), loss, Evaluator, Trainer
  parallel/ the train step and optimizer; data parallelism across processes
            (``dist``: NCCL on the card, gloo on the CPU)
  data/     datasets, augmentations, loaders
  native/   the C++ data path (JPEG decode, crop, normalize), built with g++
  csrc/     CUDA C++ sources, built with nvcc at first use
  kernels/  the build of ``csrc`` and its ctypes bindings, launch counts
  train.py, eval.py   the CLIs (``python -m maed_tpu_torch.train`` / ``.eval``)
  serve.py  the HTTP host over an exported artifact (``python -m maed_tpu_torch.serve``)
  tools/    ``bench_serve`` (HTTP throughput), ``time_requests`` (eager request ms)

The package imports torch and numpy only: never jax, flax, pyyaml, cv2, PIL
or anything of ``maed_tpu`` (joblib only where it is installed), and never
triton at import time (Triton is imported inside the function that launches
its kernel).
"""

__version__ = "0.1.0"
