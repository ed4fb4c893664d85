"""maed_tpu_torch's tensor parallelism and 'dcn' axis (``parallel.mesh``,
``parallel.tensor``) on the CPU, against ``maed_tpu/parallel/mesh.py``:

- the rank layout of (dp 4, tp 2) and (dcn 2, dp 2, tp 2) equals the JAX
  mesh's ``devices`` (rank r where device r lies), and each rank's tp and
  data groups are the rows and columns of that layout (four gloo ranks);
- ``param_spec`` of every state_dict name of the port's MAED is JAX's
  ``param_spec`` of its flax path, in torch's (out, in) layout;
- ``shard_state_dict`` then ``gather_state_dict`` gives the state_dict back
  bit for bit, and a rank's qkv holds the q, k and v rows of its heads;
- four gloo ranks: one train step at (dcn 2, dp 1, tp 2) equals the step at
  (dp 2, tp 2) bit for bit (the loss terms, the full gradient and the
  updated parameters), as tests/test_train.py holds the two JAX meshes
  equal;
- a trainer's checkpoint at tp = 2 (two gloo ranks) holds the full,
  reference-named parameters and Adam moments: it resumes at tp = 2 into
  the writer's shards bit for bit, loads ``strict=True`` into one process,
  and a one-process trainer resumed from it writes it back bit for bit.

The ranks run the tiny MAED of tests/test_torch_port_train.py with the
hybrid stem cut to one bottleneck a stage, in f64. (The tp = 2 step against
JAX's whole-batch step: tests/test_torch_port_train.py and
tests/test_torch_port_stage1.py.)
"""

import jax
import numpy as np
import pytest
import torch

from maed_tpu.models import MAED as JMAED
from maed_tpu.parallel import mesh as jmesh
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_smpl
from maed_tpu_torch.core.builder import init_weights_
from maed_tpu_torch.core.config import get_cfg_defaults
from maed_tpu_torch.core.loss import LossWeights
from maed_tpu_torch.core.trainer import Trainer
from maed_tpu_torch.models import vit
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.parallel import mesh as tmesh
from maed_tpu_torch.parallel import train_step as TS
from maed_tpu_torch.utils import checkpoint as ckpt
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model
from maed_tpu_torch.utils.weights import translate_flax_path
from test_torch_port_models import random_params
from test_torch_port_train import CONFIG, RES, _batches, _halves, _Optim, _tree
from torch_port_common import Ranks, one_torch_thread, to_torch  # noqa: F401

MODEL = dict(img_size=RES, decoder_drop=0.0, **CONFIG)


def _narrow_maed(monkeypatch, seed):
    """The tiny MAED with one bottleneck a stem stage, f64, seeded weights."""
    monkeypatch.setattr(vit, "ResNetV2", lambda **kw: ResNetV2(**dict(kw, layers=(1, 1, 1))))
    model = MAED(**MODEL, dtype=torch.float64).double()
    init_weights_(model, seed)
    return model


@pytest.fixture(scope="module")
def state_dicts():
    with pytest.MonkeyPatch.context() as mp:
        return [_narrow_maed(mp, seed).state_dict() for seed in (0, 1)]


def _optim():
    return {k: v for k, v in vars(_Optim).items() if k.isupper()}


@pytest.fixture(scope="module")
def four_ranks(state_dicts, checkpoint_ranks, tmp_path_factory):
    """Four gloo ranks: the layouts of (dp 2, tp 2) and (dcn 2, dp 1, tp 2),
    then one step in each (the data ranks on the halves of batch 1); started
    after the two of ``checkpoint_ranks``, which run meanwhile."""
    vids, imgs = _halves(1)
    job = dict(model=MODEL, narrow_stem=True, state_dict=state_dicts[0], num_verts=64,
               optim=_optim(), calls=[(vids, imgs)])
    return Ranks([{"layout": dict(dp=2, tp=2)}, {"layout": dict(dcn=2, dp=1, tp=2)},
                  dict(job, mesh=dict(dp=2, tp=2)), dict(job, mesh=dict(dcn=2, dp=1, tp=2))],
                 tmp_path_factory.mktemp("four_ranks"), world=4)


@pytest.fixture(scope="module")
def checkpoint_ranks(state_dicts, tmp_path_factory):
    """Two gloo ranks at tp = 2: a step, the trainer's checkpoint, a resume
    into a trainer of other weights."""
    vid, img = (_tree(b, to_torch) for b in _batches(1))
    out = tmp_path_factory.mktemp("tp_checkpoint")
    ranks = Ranks([dict(checkpoint=True, mesh=dict(tp=2), model=MODEL, narrow_stem=True,
                        state_dict=state_dicts[0], other_state_dict=state_dicts[1],
                        num_verts=64, optim=_optim(), call=([vid], [img]))], out)
    return ranks, out


def _jax_layout(**shape):
    n = int(np.prod(list(shape.values())))
    return np.vectorize(lambda d: d.id)(jmesh.make_mesh(**shape, devices=jax.devices()[:n])
                                        .devices)


@pytest.mark.parametrize("shape", [dict(dp=4, tp=2), dict(dcn=2, dp=2, tp=2)])
def test_rank_layout_is_the_jax_mesh(shape):
    """Rank r of the port's mesh lies where device r lies in the JAX mesh,
    with the JAX mesh's axis sizes; its (dcn, dp, tp) indices, tp rank and
    data rank are read off that position (the data axes jointly)."""
    want = _jax_layout(**shape)
    dcn = shape.get("dcn", 1)
    for r in range(want.size):
        m = tmesh.Mesh(dcn=dcn, dp=shape["dp"], tp=shape["tp"], rank=r)
        assert np.array_equal(m.ranks(), want)
        assert m.shape == dict(jmesh.make_mesh(**shape, devices=jax.devices()[:want.size]).shape)
        pos = tuple(int(i) for i in np.argwhere(want == r)[0])
        assert m.coords == (pos if dcn > 1 else (0,) + pos)
        assert m.tp_rank == pos[-1] and m.data_rank == np.ravel_multi_index(
            pos[:-1], want.shape[:-1])


def test_groups_of_four_ranks(four_ranks):
    """make_mesh on four gloo ranks: each rank's tp group is its row of the
    JAX layout, its data group its column over the data axes, which
    ``parallel.dist`` then reduces over (the mean of rank + 1 over the
    column); (dcn 2, dp 1, tp 2) lays the ranks out as (dp 2, tp 2)."""
    results = four_ranks.results()
    for job, shape in enumerate([dict(dp=2, tp=2), dict(dcn=2, dp=1, tp=2)]):
        want = _jax_layout(**shape).reshape(-1, 2)  # rows: (dcn, dp) indices; columns: tp
        for r, res in enumerate(results):
            got = res[job]
            row, col = np.argwhere(want == r)[0]
            assert got["tp_group"] == want[row].tolist()
            assert got["data_group"] == want[:, col].tolist()
            assert (got["tp_rank"], got["data_rank"], got["data_world"]) == (col, row, 2)
            assert got["dist_data"] == (row, 2)
            assert got["mean"] == [np.mean(want[:, col] + 1.0)]


def test_param_spec_is_the_jax_rule_for_every_name():
    """Every parameter of the port's (parallel-mode) MAED: its spec is the
    JAX rule of its flax path, reversed for a dense kernel (flax (in, out),
    torch (out, in)); six names a block are split, the rest replicated."""
    x = np.zeros((1, 2, RES, RES, 3), np.float32)
    jmodel = JMAED(encoder="ste", st_mode="parallel", decoder="ktd", **CONFIG)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), x, j_smpl(64, 0)), 0)
    split = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flax_path = "/".join(str(k.key) for k in path)
        name, _ = translate_flax_path(flax_path, np.zeros(leaf.shape))
        want = tuple(jmesh.param_spec(flax_path))
        if flax_path.endswith("kernel") and len(leaf.shape) == 2:
            want = tuple(reversed(want + (None,) * (2 - len(want))))
        got = tmesh.param_spec(name)
        assert (got if any(got) else ()) == (want if any(want) else ()), (name, got, want)
        split += bool(any(got))
    assert split == 6 * CONFIG["num_blocks"]


def test_shard_then_gather_is_the_identity_and_qkv_goes_by_head(state_dicts):
    """shard_state_dict on each rank of tp 2 then the gather's placement
    (what gather_tensor all-reduces, here summed in the test) is the
    state_dict bit for bit; rank t's qkv rows (and bias) are rows j C + t C/2
    .. j C + (t + 1) C/2 of q, k and v (j = 0, 1, 2): its one head's."""
    sd = state_dicts[0]
    C = 768
    shards = [tmesh.shard_state_dict(sd, tmesh.Mesh(1, 1, 2, rank=t)) for t in range(2)]
    for name, full in sd.items():
        spec = tmesh.param_spec(name)
        if not any(spec):
            assert all(s[name] is full for s in shards), name
            continue
        dim = spec.index("tp")
        assert shards[0][name].shape[dim] * 2 == full.shape[dim]
        placed = torch.zeros_like(full)
        for t, s in enumerate(shards):
            part = torch.zeros_like(full)
            idx = tmesh._index(name, full.shape[dim], 2, t)
            part.index_copy_(dim, idx, s[name])
            placed += part
        assert torch.equal(placed, full), name
    for t, s in enumerate(shards):
        for key in ("encoder.blocks.0.attn.qkv.weight", "encoder.blocks.0.attn.qkv.bias"):
            rows = torch.cat([sd[key][j * C + t * C // 2:j * C + (t + 1) * C // 2]
                              for j in range(3)])
            assert torch.equal(s[key], rows), key


def test_mesh_refuses_what_does_not_divide(monkeypatch):
    """W = dcn dp tp, or make_mesh raises; tp must divide the heads and 4C."""
    with pytest.raises(ValueError, match="needs"):
        tmesh.make_mesh(tp=2)
    with pytest.raises(ValueError, match="must divide the heads"):
        vit.StAttention(768, 3, mesh=tmesh.Mesh(1, 1, 2))
    with pytest.raises(ValueError, match="must divide the hidden_width"):
        vit.Mlp(768, 3071, mesh=tmesh.Mesh(1, 1, 2))


def test_dcn_2_dp_1_tp_2_equals_dp_2_tp_2_bit_for_bit(four_ranks):
    """The 'dcn' axis is only the layout: the same step on (dcn 2, dp 1,
    tp 2) and (dp 2, tp 2) gives the same loss terms, full gradient and
    updated parameters bit for bit, and the four ranks end equal."""
    results = four_ranks.results()
    flat, dcn = results[0][2], results[0][3]
    assert flat["metrics"] == dcn["metrics"]
    for key in ("grads", "params"):
        assert flat[key].keys() == dcn[key].keys()
        for name in flat[key]:
            assert torch.equal(flat[key][name], dcn[key][name]), (key, name)
    assert all(res[job]["same_as_rank0"] for res in results[1:] for job in (2, 3))


def test_tp2_checkpoint_round_trip_with_one_process(monkeypatch, checkpoint_ranks, state_dicts):
    """The tp = 2 trainer's checkpoint resumes at tp = 2 into the writer's
    shards (parameters, Adam's moments, the generator) bit for bit; its
    state_dict has the reference names and full shapes and loads
    ``strict=True`` into one process's model; a one-process trainer resumed
    from it writes the same checkpoint again, bit for bit."""
    ranks, out = checkpoint_ranks
    results = [res[0] for res in ranks.results()]
    for res in results:
        assert res["params"] and res["moments"] and res["generator"], res
        assert res["calls"] == 1
    path = str(out / "tp_checkpoint.pth.tar")
    saved = ckpt.load_checkpoint(path)
    assert saved["state_dict"].keys() == state_dicts[0].keys()
    for name, full in state_dicts[0].items():
        assert saved["state_dict"][name].shape == full.shape, name
    qkv = saved["state_dict"]["encoder.blocks.0.attn.qkv.weight"]
    for t, res in enumerate(results):
        assert torch.equal(res["local_qkv"], tmesh.shard_tensor(
            "encoder.blocks.0.attn.qkv.weight", qkv, tmesh.Mesh(1, 1, 2, rank=t)))

    model = _narrow_maed(monkeypatch, 2).train()
    model.load_state_dict(saved["state_dict"], strict=True)
    smpl = synthetic_smpl_model(64, 0, device="cpu")
    opt = TS.make_optimizer(type("Optim", (), _optim()), 10, model.parameters())
    gen = torch.Generator()
    step = TS.make_train_step(model, opt, smpl, LossWeights(), gen)
    trainer = Trainer({}, step, model, opt, gen, smpl, get_cfg_defaults(), num_iters_per_epoch=1)
    trainer.resume(path)
    again = trainer.state(0, 1.0)
    for name, t in saved["state_dict"].items():
        assert torch.equal(again["state_dict"][name], t), name
    for idx, per in saved["optimizer"]["state"].items():
        for k, v in per.items():
            assert torch.equal(again["optimizer"]["state"][idx][k], v), (idx, k)
    assert torch.equal(again["generator"], saved["generator"])
