"""Export and serving of the port (maed_tpu_torch.utils.export, .serve,
.tools.bench_serve) against the JAX package's (maed_tpu/utils/export.py, the
root serve.py) on the CPU.

One tiny parallel MAED (1 block, 2 heads, KTD hidden 32, 32^2 frames, batch
2, 4 frames, the narrow stem of ``torch_port_common.narrow_models`` on both
sides) with random JAX weights, carried across by
``utils/weights.py::state_dict_from_jax`` into a .pth.tar, the synthetic
6890-vertex body and a (17, V) h36m regressor placed where the eval
protocol looks for it. The JAX side is exported once
(``export_eval_forward(platforms=("cpu",))``, uint8 input, the regressor
baked, at the highest matmul precision: its f32 dots are coarser by default
on this CPU) and served by its ``serve.ModelHost``. The port's artifacts
come from its CLI (``--device cpu --batch 2 1``: uint8, batches 2 and 1)
and from ``export_eval_forward`` (f32 input; args mode). Against JAX at the
f32 tolerance of tests/test_torch_port_slice.py (atol 1e-4, rtol 1e-3);
the port's artifacts against each other and against the eager port model
bit for bit; the batch-1 bucket against the batch-2 artifact at that f32
tolerance (another batch size may sum in another order).
"""

import contextlib
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

import serve as j_serve
from maed_tpu.models import MAED as JMAED
from maed_tpu.models import vit as j_vit
from maed_tpu.models.resnetv2 import ResNetV2 as JResNetV2
from maed_tpu.utils.checkpoint import fold_weight_standardization as j_fold
from maed_tpu.utils.export import export_eval_forward as j_export
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch import serve as t_serve
from maed_tpu_torch.core.builder import build_eval_model
from maed_tpu_torch.ops.image import device_normalize
from maed_tpu_torch.tools import bench_serve
from maed_tpu_torch.utils import export as TX
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import random_params
from torch_port_common import NARROW_STEM_LAYERS, assert_close, narrow_models  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401

VERTS, IMG, SHAPE = 6890, 32, (2, 4, 32, 32, 3)
CONFIG = dict(num_blocks=1, num_heads=2, hidden_dim=32)
OPS = {"groupnorm": 13, "ln_dense": 1, "spatial_attention_btc": 1, "temporal_attention_btc": 1,
       "gate_proj": 1, "ln_mlp": 1, "layernorm": 1, "skinning": 1}
TINY_CFG = """\
MODEL:
  ENCODER:
    NUM_BLOCKS: 1
    NUM_HEADS: 2
    SPA_TEMP_MODE: parallel
  DECODER:
    HIDDEN_DIM: 32
DATASET:
  WIDTH: 32
  HEIGHT: 32
EVAL:
  SEQLEN: 4
"""


def assert_answers_close(got, want):
    assert set(got) >= set(TX.OUT_KEYS)
    for key in TX.OUT_KEYS:
        assert tuple(got[key].shape) == want[key].shape, key
        assert_close(got[key], want[key], 1e-4, 1e-3, what=key)


def assert_answers_equal(got, want):
    for key in TX.OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX export and host, the port's artifacts and hosts, the eager
    port model, and the clips and answers they share."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.RandomState(0)
    clips = rng.randint(0, 256, SHAPE).astype(np.uint8)
    jreg = rng.rand(17, VERTS).astype(np.float32) ** 8  # a few vertices a joint
    jreg /= jreg.sum(axis=1, keepdims=True)
    out = {"clips": clips, "jreg": jreg, "tmp": tmp}
    with pytest.MonkeyPatch.context() as mp:
        narrow_models(mp)
        mp.setattr(j_vit, "ResNetV2",
                   lambda **kw: JResNetV2(**dict(kw, layers=NARROW_STEM_LAYERS)))
        mp.chdir(tmp)  # the CLI reads data/smpl_data/J_regressor_h36m.npy from here

        j_smpl = j_synthetic_smpl(VERTS, 0)
        x = np.zeros(SHAPE, np.float32)
        params = random_params(lambda: JMAED(encoder="ste", st_mode="parallel", decoder="ktd",
                                             **CONFIG).init(jax.random.PRNGKey(0), x, j_smpl), 0)
        j_model = JMAED(encoder="ste", st_mode="parallel", decoder="ktd", standardize_ws=False,
                        **CONFIG)
        with jax.default_matmul_precision("highest"):
            blob = j_export(j_model, {"params": j_fold(params)}, j_smpl, 2, 4, IMG, IMG,
                            J_regressor=jreg, platforms=("cpu",), input_dtype="u8")
        (tmp / "jax.hlo").write_bytes(blob)
        out["j_host"] = j_serve.ModelHost(str(tmp / "jax.hlo"))
        out["want"] = out["j_host"].predict(clips)

        sd = state_dict_from_jax(params)
        torch.save({"state_dict": sd}, tmp / "jax.pth.tar")
        (tmp / "tiny.yaml").write_text(TINY_CFG)
        (tmp / "data" / "smpl_data").mkdir(parents=True)
        np.save(tmp / "data" / "smpl_data" / "J_regressor_h36m.npy", jreg)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            TX.main(["--cfg", "tiny.yaml", "--checkpoint", "jax.pth.tar", "--out", "m.pt2",
                     "--batch", "2", "1", "--device", "cpu", "--dtype", "f32",
                     "--allow_synthetic_smpl"])
        out["cli_log"] = log.getvalue()

        model, smpl = build_eval_model(**CONFIG, img_size=IMG, dtype=torch.float32,
                                       device="cpu", state_dict=sd, allow_synthetic_smpl=True)
        out["eager"] = model(torch.from_numpy(clips), smpl, J_regressor=torch.from_numpy(jreg))
        (tmp / "f32.pt2").write_bytes(TX.export_eval_forward(
            model, smpl, 2, 4, IMG, IMG, J_regressor=jreg, input_dtype="f32"))
        args_blob, flat = TX.export_eval_forward(model, smpl, 2, 4, IMG, IMG, J_regressor=jreg,
                                                 bake_params=False)
        (tmp / "args.pt2").write_bytes(args_blob)
        np.savez(tmp / "args.pt2.params.npz", **flat)
        out["flat"] = flat

    out["bucketed"] = t_serve.BucketedHost([str(tmp / "m.pt2"), str(tmp / "m.pt2.b1")])
    out["b1"], out["b2"] = out["bucketed"].hosts
    out["f32"] = t_serve.ModelHost(str(tmp / "f32.pt2"))
    out["args"] = t_serve.ModelHost(str(tmp / "args.pt2"))
    return out


@pytest.mark.parametrize("input_dtype", ["u8", "f32"])
def test_artifact_matches_the_jax_export(served, input_dtype):
    """The CLI's uint8 artifact and the f32 one (fed the clips normalized as
    the port's model normalizes them) against JAX's exported forward; the
    uint8 one also equals the eager port model bit for bit, and its graph
    holds the parallel path's kernels as operators."""
    clips = served["clips"]
    if input_dtype == "u8":
        fwd = served["b2"].fwd
        got = fwd(clips)
        assert_answers_equal({k: v.numpy() for k, v in got.items()},
                             {k: v.numpy() for k, v in served["eager"].items()})
    else:
        fwd = served["f32"].fwd
        got = fwd(device_normalize(torch.from_numpy(clips)))
    assert fwd.spec["dtype"] == {"u8": "uint8", "f32": "float32"}[input_dtype]
    assert fwd.spec["device"] == "cpu" and fwd.spec["mode"] == "baked"
    assert fwd.spec["torch"] == torch.__version__
    assert fwd.spec["outputs"] == list(TX.OUT_KEYS)
    assert dict(fwd.ops) == OPS
    assert got["kp_3d"].shape == (2, 4, 17, 3)
    assert_answers_close(got, served["want"])


def test_args_mode_artifact(served):
    """The weights as arguments: the program less than half the baked file,
    the weights through an .npz and back, the baked artifact's answers bit
    for bit."""
    tmp = served["tmp"]
    assert (tmp / "args.pt2").stat().st_size < (tmp / "m.pt2").stat().st_size / 2
    with np.load(tmp / "args.pt2.params.npz") as npz:
        loaded = dict(npz)
    assert set(loaded) == set(served["flat"]) == set(served["args"].fwd.spec["params"])
    got = served["args"].fwd(loaded, served["clips"])
    assert_answers_equal(got, served["b2"].fwd(served["clips"]))
    assert_answers_equal(served["args"].predict(served["clips"]), served["b2"].predict(
        served["clips"]))


def test_exported_forward_refuses_what_its_spec_does_not_take(served):
    fwd, clips = served["b2"].fwd, served["clips"]
    with pytest.raises(ValueError, match="must be uint8 .* got float32"):
        fwd(clips.astype(np.float32))  # never cast: normalized floats are not raw pixels
    with pytest.raises(ValueError, match=r"must be \(2, 4, 32, 32, 3\)"):
        fwd(clips[:1])
    with pytest.raises(ValueError, match="must be float32"):
        served["f32"].fwd(clips)
    args = served["args"].fwd
    with pytest.raises(TypeError, match="flat_params, images"):
        args(clips)
    flat = dict(served["flat"])
    flat.pop(next(iter(flat)))
    with pytest.raises(ValueError, match="missing"):
        args(flat, clips)
    with pytest.raises(ValueError, match="not an artifact"):
        TX.read_spec(b"PK\x05\x06" + bytes(18))  # an empty zip archive


def test_model_host_pads_trims_and_matches_the_jax_host(served):
    host, j_host, clips = served["b2"], served["j_host"], served["clips"]
    assert host.spec()["batch"] == 2 and host.spec()["dtype"] == "uint8"
    one = host.predict(clips[:1])  # padded to the exported batch, trimmed back
    assert one["theta"].shape == (1, 4, 85)
    assert_answers_equal(one, {k: v[:1] for k, v in host.predict(clips).items()})
    assert_answers_close(one, j_host.predict(clips[:1]))
    with pytest.raises(ValueError, match="outside"):
        host.predict(np.zeros((3,) + SHAPE[1:], np.uint8))
    with pytest.raises(ValueError, match="must be"):
        host.predict(np.zeros((1, 4, 16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="must be uint8"):  # the JAX host casts these
        host.predict(clips.astype(np.float32))


def post(conn, images):
    buf = io.BytesIO()
    np.save(buf, images)
    conn.request("POST", "/predict", body=buf.getvalue())
    r = conn.getresponse()
    return r.status, r.read()


def test_http_protocol_and_the_bench(served):
    """/healthz and /predict over a live server on a loopback port: 503 while
    it warms up, then npy in and npz out with JAX's answers, 400 on a bad
    shape and on a dtype other than the artifact's (naming it), 404
    elsewhere; the bench tool against the same server, and with a host of
    its own."""
    ready = threading.Event()
    server = t_serve.ThreadingHTTPServer(("127.0.0.1", 0),
                                         t_serve.make_handler(served["bucketed"], ready))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/healthz")
        spec = json.loads(conn.getresponse().read())
        assert spec["ready"] is False and spec["buckets"] == [1, 2] and spec["batch"] == 2
        assert post(conn, served["clips"])[0] == 503
        ready.set()
        status, body = post(conn, served["clips"])
        assert status == 200
        assert_answers_close(dict(np.load(io.BytesIO(body))), served["want"])
        status, body = post(conn, np.zeros((5,) + SHAPE[1:], np.uint8))
        assert status == 400 and b"outside" in body
        status, body = post(conn, served["clips"].astype(np.float32))
        assert status == 400 and b"must be uint8" in body
        conn.request("GET", "/nowhere")
        r = conn.getresponse()
        r.read()
        assert r.status == 404
        conn.close()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            bench_serve.main(["--url", f"http://127.0.0.1:{port}", "--iters", "2",
                              "--warmup", "1"])
        line = json.loads(log.getvalue().strip().splitlines()[-1])
        assert line["metric"] == "serve_clips_per_s" and line["value"] > 0
        assert line["batch"] == 2 and line["dtype"] == "uint8"
        assert line["request_bytes"] > np.prod(SHAPE) and "card" in line
        log = io.StringIO()  # with a host of its own over an artifact
        with contextlib.redirect_stdout(log):
            bench_serve.main(["--artifact", str(served["tmp"] / "m.pt2.b1"), "--iters", "2",
                              "--warmup", "1"])
        assert json.loads(log.getvalue().strip().splitlines()[-1])["batch"] == 1
    finally:
        server.shutdown()
        server.server_close()


def test_bucketed_host_routes_by_batch(served, monkeypatch):
    bucketed, b1, b2, clips = served["bucketed"], served["b1"], served["b2"], served["clips"]
    one, two = bucketed.predict(clips[:1]), bucketed.predict(clips)
    assert_answers_equal(one, b1.predict(clips[:1]))
    assert_answers_equal(two, b2.predict(clips))
    assert_answers_close(one, {k: v[:1] for k, v in two.items()})
    with pytest.raises(ValueError, match="outside"):
        bucketed.predict(np.zeros((3,) + SHAPE[1:], np.uint8))
    hosts = {"b1": b1, "f32": served["f32"]}  # buckets of one artifact, not of two contracts
    monkeypatch.setattr(t_serve, "ModelHost", lambda path, params="": hosts[path])
    with pytest.raises(ValueError, match="differ beyond batch"):
        t_serve.BucketedHost(["b1", "f32"])


def test_export_cli(served, monkeypatch):
    """``--device cpu --batch 2 1``: <out> at batch 2 and <out>.b1, uint8 in
    (the default), the checkpoint's weights and the regressor from the data
    directory; the default device is the card, which it never trades for
    the CPU."""
    tmp, log = served["tmp"], served["cli_log"]
    assert "wrote m.pt2:" in log and "wrote m.pt2.b1:" in log and "device=cpu" in log
    for name, batch in (("m.pt2", 2), ("m.pt2.b1", 1)):
        spec = TX.read_spec(str(tmp / name))
        assert (spec["batch"], spec["seqlen"], spec["height"], spec["width"]) == (batch, 4, 32, 32)
        assert spec["dtype"] == "uint8" and spec["device"] == "cpu"
    assert served["b1"].fwd.ops == served["b2"].fwd.ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda needs a CUDA device"):
        TX.main(["--out", str(tmp / "never.pt2")])
    assert not (tmp / "never.pt2").exists()
