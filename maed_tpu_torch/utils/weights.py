"""Carry the JAX package's parameters across to the port.

``maed_tpu/utils/torch_convert.py`` (which imports only ``re`` and numpy, so
it runs where JAX is absent) maps a flax parameter tree onto the reference
torch MAED's state_dict names and layouts. The port's modules use those
names, so the result loads with ``load_state_dict(..., strict=True)``, as the
released ``.pth.tar`` will.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A flax MAED parameter tree (numpy leaves) -> the port's state_dict."""
    from maed_tpu.utils.torch_convert import convert_params_to_state_dict

    return {key: torch.from_numpy(np.ascontiguousarray(value))
            for key, value in convert_params_to_state_dict(params).items()}
