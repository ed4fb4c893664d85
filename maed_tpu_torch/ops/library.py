"""The port's kernels as registered operators, in the namespace ``maed_torch``.

Every kernel that :func:`maed_tpu_torch.ops.recompute.differentiable` takes
is also an operator with three implementations:

- CUDA: the kernel's launch, as its wrapper makes it (it raises where the
  kernel does not take the operands);
- CPU: the kernel's plain PyTorch version;
- fake: the plain version run on fake tensors, which gives the output's
  shape, dtype and strides and neither builds nor launches anything.

While ``torch.export`` traces, ``differentiable`` calls the operator, and
the export keeps it as one node of the graph, so an exported program
(``utils.export``) launches the same kernels as the eager forward, and a
program loaded in another process finds them again by name. Eager calls
launch the kernel directly: the dispatcher's route to a Python kernel costs
host time at every call, so a loaded program too calls each operator's
:func:`direct` function in its place. Each operator is defined where its
kernel is, when that module is imported; :func:`load` imports every such
module, which is all that a process running an exported program needs of
the port.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "maed_torch"
OP_MODULES = ("attention", "groupnorm", "layernorm", "mlp", "skinning", "st_attention")

_LIB = torch.library.Library(NAMESPACE, "DEF")
_OPERATORS: dict = {}  # kernel function -> its operator
_DIRECT: dict = {}  # operator -> its implementations without the dispatcher


def define(schema: str, kernel, plain):
    """Register ``maed_torch::<schema>`` with ``kernel`` for CUDA tensors and
    ``plain`` for CPU and fake ones; returns the operator's overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, kernel, "CUDA")
    _LIB.impl(name, plain, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", plain, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default

    def call(*args):
        return (plain if args[0].device.type == "cpu" else kernel)(*args)

    call.__name__ = call.__qualname__ = f"{name}_direct"  # a name for an FX graph's code
    _OPERATORS[kernel], _DIRECT[op] = op, call
    return op


def operator(kernel):
    """The registered operator of a kernel function given to :func:`define`."""
    return _OPERATORS[kernel]


def direct(op):
    """What ``op`` dispatches to, without the dispatcher: its plain version
    for a CPU tensor, else its kernel (which raises where it has none)."""
    return _DIRECT[op]


def load() -> None:
    """Define every operator of the port (import the modules that hold them)."""
    for module in OP_MODULES:
        importlib.import_module(f"maed_tpu_torch.ops.{module}")
