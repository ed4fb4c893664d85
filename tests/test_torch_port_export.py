"""The exported eval forward (maed_tpu_torch.utils.export) against the eager
port model, on the CPU: every attention mode of the stage-2 model and the
two stage-1 models, each exported, saved, loaded by ``load_exported`` and
run on the same uint8 clips with a baked regressor. The loaded program runs
the same ATen ops and the same kernels' operators in the same order as the
eager forward, so the five outputs are equal bit for bit. Its graph holds
each kernel of the mode's path as one ``maed_torch::`` node, as many times
as the eager forward calls it: I (GroupNorm), C (LN + MLP), B (the final
LayerNorm) and A (skinning) in every stage-2 mode, D (LN + qkv) and the
attention of each mode, E (the gated tail) in 'parallel', K (the blocked
attention) in 'coupling' (whose tiny clip of 20 tokens takes it with the
one-shot limit lowered to 16), and A alone in the stage-1 models.

Tiny models (1 block, 2 heads, KTD hidden 32, 32^2 frames, batch 2, 4
frames, a 120-vertex synthetic body, f32) with the narrow stem of
``torch_port_common.narrow_models`` (one bottleneck a stage), since an
export's cost grows with the nodes of its graph.
"""

import collections

import numpy as np
import pytest
import torch

from maed_tpu_torch.core.builder import build_eval_model
from maed_tpu_torch.models import vit
from maed_tpu_torch.ops import attention as TA
from maed_tpu_torch.utils.export import OUT_KEYS, export_eval_forward, load_exported
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model
from torch_port_common import narrow_models, one_torch_thread  # noqa: F401

VERTS, IMG, SHAPE = 120, 32, (2, 4, 32, 32, 3)
STEM_NORMS = 13  # the narrow stem's GroupNorms: the stem's, then 4 a stage
BLOCK_OPS = {
    "vanilla": ("ln_dense", "spatial_attention_btc"),
    "spatial": ("ln_dense", "spatial_attention_btc"),
    "temporal": ("layernorm", "temporal_attention_btc"),
    "coupling": ("ln_dense", "attention_blocked"),
    "parallel": ("ln_dense", "spatial_attention_btc", "temporal_attention_btc", "gate_proj"),
    "series": ("ln_dense", "spatial_attention_btc", "temporal_attention_btc"),
}
MODELS = [("ste", "ktd", mode) for mode in vit.ST_MODES] + [("cnn", "ktd", "parallel"),
                                                              ("cnn", "iterative", "parallel")]


def expected_ops(encoder, st_mode):
    if encoder == "cnn":  # the ResNet-50 is convolutions and BatchNorm: cuDNN on the card
        return collections.Counter(skinning=1)
    ops = collections.Counter(groupnorm=STEM_NORMS, ln_mlp=1, layernorm=1, skinning=1)
    ops.update(BLOCK_OPS[st_mode])
    return ops


@pytest.mark.parametrize("encoder, decoder, st_mode", MODELS,
                         ids=[f"{e}-{d}-{m}" if e == "cnn" else m for e, d, m in MODELS])
def test_loaded_artifact_equals_the_eager_model(monkeypatch, encoder, decoder, st_mode):
    narrow_models(monkeypatch)
    if st_mode == "coupling":
        monkeypatch.setattr(TA, "MAX_TOKENS", 16)
        monkeypatch.setattr(vit, "MAX_TOKENS", 16)
    model, _ = build_eval_model(encoder=encoder, decoder=decoder, st_mode=st_mode, num_blocks=1,
                                num_heads=2, hidden_dim=32, img_size=IMG, dtype=torch.float32,
                                device="cpu", seed=3, allow_synthetic_smpl=True)
    smpl = synthetic_smpl_model(VERTS, 0, device="cpu")
    rng = np.random.RandomState(4)
    clips = rng.randint(0, 256, SHAPE).astype(np.uint8)
    jreg = rng.rand(14, VERTS).astype(np.float32)
    fwd = load_exported(export_eval_forward(model, smpl, 2, 4, IMG, IMG, J_regressor=jreg,
                                            device="cpu"))
    assert fwd.spec["device"] == "cpu" and fwd.spec["dtype"] == "uint8"
    assert fwd.ops == expected_ops(encoder, st_mode)
    got = fwd(clips)
    want = model(torch.from_numpy(clips), smpl, J_regressor=torch.from_numpy(jreg))
    assert set(got) == set(OUT_KEYS)
    for key in OUT_KEYS:
        assert not got[key].requires_grad and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
