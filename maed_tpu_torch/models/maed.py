"""MAED: the STE hybrid-ViT encoder and the KTD decoder.

Port of ``maed_tpu/models/maed.py`` for encoder 'ste' (any ``st_mode``) and
decoder 'ktd'. Inputs are NHWC clips (N, T, H, W, 3), uint8 (normalized on
the device) or float; frames fold into the batch for the encoder and the
outputs unfold back to (N, T, ...).

A MAED is built in eval mode, the mode every eval caller runs it in: its
forward then runs under ``torch.inference_mode``. ``train()`` (as
``core.builder.build_train_model`` leaves it) records autograd and turns
on the dropout, whose masks come from the ``generator`` given to the
forward.
"""

from __future__ import annotations

import torch
from torch import nn

from maed_tpu_torch.models.ktd import KTD
from maed_tpu_torch.models.vit import VisionTransformer
from maed_tpu_torch.ops.image import device_normalize
from maed_tpu_torch.ops.smpl import SMPLModel


class MAED(nn.Module):
    def __init__(self, num_blocks: int = 6, num_heads: int = 12, hidden_dim: int = 1024,
                 img_size: int = 224, standardize_ws: bool = True,
                 st_mode: str = "parallel", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 decoder_drop: float = 0.5, dtype: torch.dtype = torch.float32):
        """standardize_ws=False runs the stem on weights that
        ``utils.checkpoint.fold_weight_standardization`` standardized. The
        rates are the encoder's dropout, attention dropout and (largest)
        drop-path, and KTD's dropout."""
        super().__init__()
        self.encoder = VisionTransformer(depth=num_blocks, num_heads=num_heads,
                                         representation_size=768, img_size=img_size,
                                         standardize=standardize_ws, st_mode=st_mode,
                                         drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                                         drop_path_rate=drop_path_rate, dtype=dtype)
        self.decoder = KTD(feat_dim=768, hidden_dim=hidden_dim, drop=decoder_drop, dtype=dtype)
        self.eval()

    def forward(self, x: torch.Tensor, smpl_model: SMPLModel,
                J_regressor: torch.Tensor | None = None, plain: bool = False,
                generator: torch.Generator | None = None):
        """plain=True runs the plain PyTorch versions of the kernels instead
        of the kernels (on the CPU they are what runs either way)."""
        train = self.training
        with torch.inference_mode(not train):
            x = device_normalize(x)
            N, T = x.shape[:2]
            feat = self.encoder(x.reshape((N * T,) + x.shape[2:]), seqlen=T, plain=plain,
                                train=train, generator=generator)
            out = self.decoder(feat, smpl_model, J_regressor=J_regressor, plain=plain,
                               train=train, generator=generator)
            return {
                "theta": out["theta"].reshape(N, T, -1),
                "verts": out["verts"].reshape(N, T, -1, 3),
                "kp_2d": out["kp_2d"].reshape(N, T, -1, 2),
                "kp_3d": out["kp_3d"].reshape(N, T, -1, 3),
                "rotmat": out["rotmat"].reshape(N, T, -1, 3, 3),
            }
