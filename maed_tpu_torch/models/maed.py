"""MAED: an encoder (the STE hybrid ViT, or the stage-1 ResNet-50) and a
decoder (KTD, or the iterative regressor).

Port of ``maed_tpu/models/maed.py``: encoder 'ste' (any ``st_mode``) or
'cnn', decoder 'ktd' or 'iterative'. Inputs are NHWC clips (N, T, H, W, 3),
uint8 (normalized on the device) or float; frames fold into the batch for
the encoder and the outputs unfold back to (N, T, ...). The decoder takes
the encoder's features: 768 from the ViT, 2048 from the ResNet, whose
BatchNorm runs in the module's own mode (batch statistics and their
running update in ``train()``, the running statistics in eval).
``extract_feature`` returns those features alone, (N, T, feat).

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
from maed_tpu_torch.models.resnet import ResNet50
from maed_tpu_torch.models.spin import IterativeRegressor
from maed_tpu_torch.models.vit import VisionTransformer
from maed_tpu_torch.ops.image import device_normalize
from maed_tpu_torch.ops.smpl import SMPLModel


ENCODERS, DECODERS = ("ste", "cnn"), ("ktd", "iterative")


class MAED(nn.Module):
    def __init__(self, num_blocks: int = 6, num_heads: int = 12, hidden_dim: int = 1024,
                 img_size: int = 224, standardize_ws: bool = True,
                 st_mode: str = "parallel", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 decoder_drop: float = 0.5, encoder: str = "ste", decoder: str = "ktd",
                 smpl_dir: str = "data/smpl_data", remat: bool = False,
                 dtype: torch.dtype = torch.float32, mesh=None):
        """standardize_ws=False runs the ViT's stem on weights that
        ``utils.checkpoint.fold_weight_standardization`` standardized. The
        rates are the ViT's dropout, attention dropout and (largest)
        drop-path, and the decoder's dropout. ``smpl_dir`` is where the
        iterative decoder looks for ``smpl_mean_params.npz``. ``remat``
        recomputes each ViT block's activations in the backward
        (``models.vit.remat_block``); the 'cnn' encoder has no blocks.
        ``mesh`` (``parallel.mesh.make_mesh``) with tp > 1 splits each ViT
        block over the tp group (``models.vit``); the rest is replicated."""
        super().__init__()
        self.encoder_name, self.decoder_name = encoder.lower(), decoder.lower()
        if self.encoder_name not in ENCODERS or self.decoder_name not in DECODERS:
            raise NotImplementedError(f"encoder {encoder!r} + decoder {decoder!r}: the encoders "
                                      f"are {ENCODERS}, the decoders {DECODERS}")
        if self.encoder_name == "ste":
            self.encoder = VisionTransformer(depth=num_blocks, num_heads=num_heads,
                                             representation_size=768, img_size=img_size,
                                             standardize=standardize_ws, st_mode=st_mode,
                                             drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                                             drop_path_rate=drop_path_rate, remat=remat,
                                             dtype=dtype, mesh=mesh)
            feat_dim = 768
        else:
            self.encoder = ResNet50(dtype=dtype)
            feat_dim = self.encoder.num_features
        if self.decoder_name == "ktd":
            self.decoder = KTD(feat_dim=feat_dim, hidden_dim=hidden_dim, drop=decoder_drop,
                               dtype=dtype)
        else:
            self.decoder = IterativeRegressor(feat_dim=feat_dim, hidden_dim=hidden_dim,
                                              drop=decoder_drop, data_dir=smpl_dir, dtype=dtype)
        self.eval()

    def _features(self, x, plain, train, generator):
        """The encoder's features of the clips x (N, T, H, W, 3), (N * T, feat),
        and (N, T)."""
        x = device_normalize(x)
        N, T = x.shape[:2]
        frames = x.reshape((N * T,) + x.shape[2:])
        if self.encoder_name == "cnn":
            return self.encoder(frames, train=train), (N, T)
        return self.encoder(frames, seqlen=T, plain=plain, train=train,
                            generator=generator), (N, T)

    def extract_feature(self, x: torch.Tensor, plain: bool = False,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """The encoder's per-frame features (N, T, feat) of clips (N, T, H, W,
        3), uint8 or float: 768 from the ViT, 2048 from the ResNet (the JAX
        package's ``MAED.extract_feature``); in the module's mode, as the
        forward."""
        train = self.training
        with torch.inference_mode(not train):
            feat, (N, T) = self._features(x, plain, train, generator)
            return feat.reshape(N, T, -1)

    def forward(self, x: torch.Tensor, smpl_model: SMPLModel,
                J_regressor: torch.Tensor | None = None, plain: bool = False,
                generator: torch.Generator | None = None):
        """plain=True runs the plain PyTorch versions of the kernels instead
        of the kernels (on the CPU they are what runs either way)."""
        train = self.training
        with torch.inference_mode(not train):
            feat, (N, T) = self._features(x, plain, train, generator)
            out = self.decoder(feat, smpl_model, J_regressor=J_regressor, plain=plain,
                               train=train, generator=generator)
            return {
                "theta": out["theta"].reshape(N, T, -1),
                "verts": out["verts"].reshape(N, T, -1, 3),
                "kp_2d": out["kp_2d"].reshape(N, T, -1, 2),
                "kp_3d": out["kp_3d"].reshape(N, T, -1, 3),
                "rotmat": out["rotmat"].reshape(N, T, -1, 3, 3),
            }
