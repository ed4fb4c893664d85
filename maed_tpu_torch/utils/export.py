"""Export of the eval forward for serving: one ``torch.export`` artifact.

Port of ``maed_tpu/utils/export.py``. The eval forward of a model from
``core.builder.build_eval_model`` (its stem's standardization folded),
together with its SMPL body and an optional joint regressor, becomes one
program at static shapes (batch, seqlen, height, width): one artifact per
(device, batch, seqlen), as in the JAX package. Every kernel of the forward
is a node of that program, an operator of ``ops.library``, so the artifact
launches the same hand-written kernels as the eager forward, and gives the
same answers bit for bit on the card it was made on. Once loaded, each such
node calls its kernel without the dispatcher, as the eager forward does. A serving process needs
no model code to run it: :func:`load_exported` imports torch, numpy and the
operators alone.

Baked (the default): the weights, the body and the regressor travel inside
the one file. Args mode (``bake_params=False``, ``--no_bake``): the program
takes ``(flat_params, images)``; the weights travel beside it as a flat
dict of numpy arrays, ``<out>.params.npz`` (bf16 as its bits in uint16,
since numpy has no bf16), and the program keeps only the body and the
regressor.

The artifact carries its spec (``maed_spec.json`` in the archive): the
input's shape and dtype, the device it was made for, the torch version, the
output keys and, in args mode, each weight's name, dtype and shape. The
callable :func:`load_exported` returns refuses images of another dtype or
shape with a ValueError (the JAX package's casts them, and f32 clips given
to a uint8 artifact come back as plausible garbage), runs under
``torch.inference_mode()``, and raises where the process has no device of
the kind the artifact was made for.

CLI:
    python -m maed_tpu_torch.utils.export --cfg configs/config_stage2.yaml \\
        [--checkpoint ckpt.pth.tar] --out m.pt2 --batch 8 2 \\
        [--device cuda|cpu] [--dtype bf16|f32] [--input_dtype u8|f32] \\
        [--eval_ds 3dpw] [--allow_synthetic_smpl] [--no_bake]
Serving:
    from maed_tpu_torch.utils.export import load_exported
    fwd = load_exported("m.pt2")
    preds = fwd(images)          # (B, T, H, W, 3) in the spec's dtype
"""

from __future__ import annotations

import collections
import io
import json
import os
import zipfile

import numpy as np
import torch

from maed_tpu_torch.ops import library

SPEC_FILE = "maed_spec.json"
OUT_KEYS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")
INPUT_DTYPES = {"u8": torch.uint8, "f32": torch.float32}


class _BoundForward(torch.nn.Module):
    """The eval forward bound to its SMPL body and regressor, which it holds
    as buffers (``SMPLModel`` is a NamedTuple, which an export would not
    carry). Baked: ``forward(images)`` with the model as a submodule. Args
    mode: ``forward(flat_params, images)`` runs the model, which is then not
    a submodule, on the given weights."""

    def __init__(self, model, smpl, J_regressor, bake_params: bool):
        super().__init__()
        if bake_params:
            self.model = model
        else:
            self.__dict__["_unbound"] = model  # not a submodule: its weights are arguments
        self._smpl_fields, self._smpl_static = [], {}
        for name, value in smpl._asdict().items():
            if isinstance(value, torch.Tensor):
                self.register_buffer(f"smpl_{name}", value)
                self._smpl_fields.append(name)
            else:
                self._smpl_static[name] = value
        self._smpl_type = type(smpl)
        self.register_buffer("J_regressor", J_regressor)

    def _smpl(self):
        tensors = {name: getattr(self, f"smpl_{name}") for name in self._smpl_fields}
        return self._smpl_type(**tensors, **self._smpl_static)

    def forward(self, *args):
        smpl = self._smpl()
        if len(args) == 1:
            return self.model(args[0], smpl, J_regressor=self.J_regressor)
        flat_params, images = args
        return torch.func.functional_call(self._unbound, flat_params, (images, smpl),
                                          {"J_regressor": self.J_regressor})


def _flat_weights(model) -> dict:
    """Every parameter and buffer of ``model`` (the non-persistent ones too:
    the iterative decoder's mean parameters), by state_dict name."""
    return dict(model.named_parameters()) | dict(model.named_buffers())


def _drop_noop_casts(program) -> None:
    """Take out of the exported graph the casts of a tensor to its own dtype
    (the model casts its weights at use, which ``cast_weights_`` made no-ops)
    and the dtype checks the export adds beside every cast: about a third of
    the nodes, each a dispatch at every request, and of the artifact's save
    and load. What the graph computes is unchanged."""
    graph = program.graph
    for node in list(graph.nodes):
        if node.target == torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target == torch.ops.aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and node.args[0].meta["val"].dtype == node.meta["val"].dtype):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def export_eval_forward(model, smpl, batch_size: int, seqlen: int, height: int = 224,
                        width: int = 224, J_regressor=None, device=None,
                        bake_params: bool = True, input_dtype: str = "u8"):
    """The eval forward of ``model`` (from ``build_eval_model``, in eval mode)
    with ``smpl`` and the optional (J, V) ``J_regressor`` as artifact bytes,
    for images (batch_size, seqlen, height, width, 3) of ``input_dtype``
    ('u8': raw crops, normalized in the program; 'f32': ImageNet-normalized).

    ``device`` is where the model lies (its parameters' device by default):
    the artifact runs there. bake_params=True returns the bytes of one file
    with everything in it; bake_params=False returns (bytes, flat) where
    ``flat`` maps every weight's state_dict name to a numpy array, and the
    program is called as fwd(flat, images).
    """
    if input_dtype not in INPUT_DTYPES:
        raise ValueError(f"input_dtype {input_dtype!r}: one of {sorted(INPUT_DTYPES)}")
    if model.training:
        raise ValueError("export_eval_forward: the model is in training mode; the eval "
                         "forward is that of model.eval()")
    weights = _flat_weights(model)
    device = torch.device(device) if device is not None else next(iter(weights.values())).device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    strays = sorted({str(t.device) for t in weights.values()} - {str(device)})
    if strays or smpl.v_template.device != device:
        raise ValueError(f"export_eval_forward: the model and the body must lie on {device}, "
                         f"found {strays or [str(smpl.v_template.device)]}")
    jreg = None if J_regressor is None else torch.as_tensor(
        np.asarray(J_regressor, np.float32) if not isinstance(J_regressor, torch.Tensor)
        else J_regressor, dtype=torch.float32, device=device)
    shape = (batch_size, seqlen, height, width, 3)
    images = torch.zeros(shape, dtype=INPUT_DTYPES[input_dtype], device=device)
    bound = _BoundForward(model, smpl, jreg, bake_params)
    args = (images,) if bake_params else (weights, images)
    with torch.no_grad():
        program = torch.export.export(bound, args)
    # the example inputs (in args mode the weights themselves) are not saved
    program.example_inputs = None
    _drop_noop_casts(program)
    spec = dict(
        format="maed_tpu_torch.export", mode="baked" if bake_params else "args",
        batch=batch_size, seqlen=seqlen, height=height, width=width,
        dtype=str(images.dtype).removeprefix("torch."), device=device.type,
        device_name=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        torch=torch.__version__, outputs=list(OUT_KEYS))
    if not bake_params:
        spec["params"] = {name: [str(t.dtype).removeprefix("torch."), list(t.shape)]
                          for name, t in weights.items()}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={SPEC_FILE: json.dumps(spec)})
    if bake_params:
        return buf.getvalue()
    return buf.getvalue(), {name: _to_numpy(t) for name, t in weights.items()}


def read_spec(artifact) -> dict:
    """The spec of an artifact (a path or its bytes), read without loading it."""
    source = io.BytesIO(artifact) if isinstance(artifact, (bytes, bytearray)) else artifact
    with zipfile.ZipFile(source) as archive:
        names = [n for n in archive.namelist() if n.endswith("/extra/" + SPEC_FILE)]
        if len(names) != 1:
            raise ValueError("not an artifact of maed_tpu_torch.utils.export: no "
                             f"{SPEC_FILE} in the archive")
        return json.loads(archive.read(names[0]))


class ExportedForward:
    """A loaded artifact: ``fwd(images)`` (baked) or ``fwd(flat_params,
    images)`` (args mode) -> {key: tensor on the artifact's device}."""

    def __init__(self, program, spec: dict, device: torch.device):
        self.spec, self.device = spec, device
        self.shape = (spec["batch"], spec["seqlen"], spec["height"], spec["width"], 3)
        self.dtype = getattr(torch, spec["dtype"])
        self._module = program.module()
        # the kernels' operators among the program's nodes (name -> count),
        # each then called without the dispatcher, as the eager forward calls
        # it (ops.library.direct): the route to a Python kernel would add
        # host time at each of a request's ~80 calls (PERF.md)
        self.ops = collections.Counter()
        graph = self._module.graph
        for node in graph.nodes:
            if node.op == "call_function" and str(node.target).startswith(library.NAMESPACE + "."):
                self.ops[str(node.target).split(".")[1]] += 1
                node.target = library.direct(node.target)
        self._module.recompile()

    @property
    def takes_params(self) -> bool:
        return self.spec["mode"] == "args"

    def _images(self, images) -> torch.Tensor:
        t = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(images))
        if t.dtype != self.dtype:
            raise ValueError(f"images must be {self.spec['dtype']} for this artifact, got "
                             f"{str(t.dtype).removeprefix('torch.')}: it takes "
                             + ("raw uint8 crops" if self.dtype == torch.uint8
                                else "ImageNet-normalized float32 crops"))
        if tuple(t.shape) != self.shape:
            raise ValueError(f"images must be {self.shape} for this artifact, got "
                             f"{tuple(t.shape)}")
        return t.to(self.device)

    def place_params(self, flat: dict) -> dict:
        """The weights of an args-mode artifact (numpy arrays, as written to
        ``.params.npz``, or tensors) as tensors of the spec's dtypes on the
        artifact's device; raises on a missing, extra or misshapen one."""
        want = self.spec["params"]
        if set(flat) != set(want):
            raise ValueError(f"params: missing {sorted(set(want) - set(flat))[:5]}, "
                             f"unexpected {sorted(set(flat) - set(want))[:5]}")
        placed = {}
        for name, (dtype, shape) in want.items():
            value = flat[name]
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(value))
            if dtype == "bfloat16" and t.dtype in (torch.uint16, torch.int16):
                t = t.view(torch.bfloat16)
            if str(t.dtype).removeprefix("torch.") != dtype or list(t.shape) != shape:
                raise ValueError(f"params[{name!r}]: {t.dtype} {tuple(t.shape)}, want "
                                 f"{dtype} {tuple(shape)}")
            placed[name] = t.to(self.device)
        return placed

    def __call__(self, *args):
        if len(args) != (2 if self.takes_params else 1):
            raise TypeError("call an args-mode artifact as fwd(flat_params, images), a baked "
                            "one as fwd(images)")
        images = self._images(args[-1])
        with torch.inference_mode():
            if self.takes_params:
                return self._module(self.place_params(args[0]), images)
            return self._module(images)


def load_exported(artifact) -> ExportedForward:
    """Load an artifact of :func:`export_eval_forward` (a path or its bytes).
    Its operators are registered first (``ops.library.load``); the kernels'
    library is built at the first launch, as in an eager process."""
    spec = read_spec(artifact)
    if spec["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"this artifact was made for a CUDA device "
                               f"({spec['device_name']}) and this process sees none")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(spec["device"])
    library.load()
    if isinstance(artifact, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(artifact))
    else:  # as a file object: torch.export.load wants a path to end in .pt2
        with open(artifact, "rb") as f:
            program = torch.export.load(f)
    return ExportedForward(program, spec, device)


def main(argv=None):
    import argparse

    from maed_tpu_torch.core.builder import build_eval_model, load_weights, model_config
    from maed_tpu_torch.core.config import get_cfg_defaults, update_cfg
    from maed_tpu_torch.core.evaluate import load_eval_regressor

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--checkpoint", default="",
                    help="a .pth.tar (core.builder.load_weights); without one the weights "
                    "are random, drawn from SEED_VALUE")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=[8], nargs="+",
                    help="exported batch size(s); several -> one artifact per size (<out> "
                    "for the first, <out>.b<N> for the rest) for the bucketed host")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the artifact runs; cuda needs a card (no fallback)")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                    help="activation dtype of the artifact; bf16 serves, f32 is eval's")
    ap.add_argument("--eval_ds", default="3dpw",
                    help="bakes this dataset's eval regressor into the artifact ('' for "
                    "the model's native joint bank)")
    ap.add_argument("--allow_synthetic_smpl", action="store_true",
                    help="the synthetic body, and the native joint bank where the eval "
                    "regressor is missing (smoke runs)")
    ap.add_argument("--input_dtype", default="u8", choices=("u8", "f32"),
                    help="'u8' takes raw uint8 crops and normalizes in the program; 'f32' "
                    "takes ImageNet-normalized crops")
    ap.add_argument("--no_bake", action="store_true",
                    help="weights as arguments: writes <out> (the program) and "
                    "<out>.params.npz")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and none is visible; pass "
                           "--device cpu to export for the CPU")
    cfg = update_cfg(args.cfg) if args.cfg else get_cfg_defaults()
    if not args.checkpoint:
        print("WARNING: no --checkpoint: the artifact holds random weights", flush=True)
    model, smpl = build_eval_model(
        **model_config(cfg), dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        device=args.device, seed=max(cfg.SEED_VALUE, 0),
        state_dict=load_weights(args.checkpoint) if args.checkpoint else None,
        allow_synthetic_smpl=args.allow_synthetic_smpl)
    jreg = (load_eval_regressor(args.eval_ds, allow_missing=args.allow_synthetic_smpl)
            if args.eval_ds else None)
    d = cfg.DATASET
    for i, batch in enumerate(args.batch):
        out = args.out if i == 0 else f"{args.out}.b{batch}"
        result = export_eval_forward(
            model, smpl, batch, cfg.EVAL.SEQLEN, d.HEIGHT, d.WIDTH, J_regressor=jreg,
            device=args.device, bake_params=not args.no_bake, input_dtype=args.input_dtype)
        extra = ""
        if args.no_bake:
            blob, flat = result
            if i == 0:  # the weights are the same for every bucket: one side file
                np.savez(args.out + ".params.npz", **flat)
                extra = f" + {args.out}.params.npz"
        else:
            blob = result
        tmp = f"{out}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, out)
        print(f"wrote {out}: {len(blob) / 2**20:.1f} MiB{extra}, device={args.device}, "
              f"dtype={args.dtype}, input={args.input_dtype}, "
              f"spec=({batch}, {cfg.EVAL.SEQLEN}, {d.HEIGHT}, {d.WIDTH}, 3)", flush=True)


if __name__ == "__main__":
    main()
