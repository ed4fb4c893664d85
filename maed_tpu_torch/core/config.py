"""Config system: a yacs-style CfgNode, the MAED config schema, and the YAML
subset the repository's configs are written in.

Port of ``maed_tpu/core/config.py``. pyyaml is not promised where the port
runs, so :func:`safe_load` and :func:`safe_dump` read and write the subset of
YAML that ``configs/*.yaml`` use (nested block mappings, block sequences,
flow sequences of scalars such as ``[]`` and ``[60, 90]``, ``{}``, single-
and double-quoted scalars, plain scalars, comments) with pyyaml's YAML 1.1
typing of plain scalars: ``5e-5`` has no dot and so stays a string, as
``yaml.safe_load`` reads it. Anything outside the subset (anchors, aliases,
tags, block scalars, flow mappings with content, timestamps, merge keys)
raises instead of being read differently.
"""

from __future__ import annotations

import argparse
import copy
import math
import os.path as osp
import re

# Dataset path constants (the JAX package's, for the same data layout).
DB_DIR = "data/database"
DATA_DIR = "data/smpl_data"
INSTA_DIR = "data/insta_variety"
INSTA_IMG_DIR = "data/insta_variety_img"
MPII3D_DIR = "data/mpi_inf_3dhp"
THREEDPW_DIR = "data/3dpw"
HUMAN36M_DIR = "data/human3.6m"
PENNACTION_DIR = "data/penn_action"
POSETRACK_DIR = "data/posetrack"


# --------------------------------------------------------------------------- #
# the YAML subset
# --------------------------------------------------------------------------- #

# pyyaml's implicit resolvers (YAML 1.1), in the order it tries them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


class YamlSubsetError(ValueError):
    """The text uses YAML outside the subset this module reads."""


def _sexagesimal(digits: str, cast):
    value = 0
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str):
    """A plain (unquoted) scalar as pyyaml's safe loader types it."""
    if _TIMESTAMP.match(text):
        raise YamlSubsetError(f"timestamps are outside the YAML subset: {text!r}")
    if text in ("<<", "=") or text[:1] in ("&", "*", "!", "|", ">", "@", "`", "%"):
        raise YamlSubsetError(f"{text!r} is outside the YAML subset")
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _NULL.match(text):
        return None
    if _INT.match(text):
        return _construct_int(text)
    if _FLOAT.match(text):
        return _construct_float(text)
    return text


def _find_comment(line: str) -> int:
    """Index where a comment starts outside quotes (# at the line's start or
    after whitespace), or len(line)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return i
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,{:-"):
            quote = c
        i += 1
    return len(line)


def _quoted(text: str, pos: int) -> tuple[str, int]:
    """The quoted scalar starting at text[pos]; returns (value, end)."""
    q, out, i = text[pos], [], pos + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(esc)
            if width is None:
                raise YamlSubsetError(f"unknown escape \\{esc} in {text!r}")
            out.append(chr(int(text[i + 2:i + 2 + width], 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise YamlSubsetError(f"unterminated quoted scalar: {text!r}")


def _scalar(text: str):
    """A whole scalar: quoted, a flow sequence of scalars, {} or plain."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise YamlSubsetError(f"text after a quoted scalar: {text!r}")
        return value
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"unterminated flow sequence: {text!r}")
        return _flow_items(text[1:-1])
    if text.startswith("{"):
        if text.replace(" ", "") != "{}":
            raise YamlSubsetError(f"flow mappings with content are outside the subset: {text!r}")
        return {}
    if re.search(r":(?:[ \t]|$)", text) or text == "-" or text.startswith("- "):
        raise YamlSubsetError(f"a mapping or sequence where a scalar belongs: {text!r}")
    return resolve_plain(text)


def _flow_items(body: str) -> list:
    items, i = [], 0
    while True:
        while i < len(body) and body[i] in " \t":
            i += 1
        if i >= len(body):  # also after a trailing comma, which pyyaml accepts
            return items
        if body[i] in "'\"":
            value, i = _quoted(body, i)
            items.append(value)
            rest = body[i:].lstrip()
        else:
            if body[i] in "[{":
                raise YamlSubsetError(f"nested flow collections are outside the subset: [{body}]")
            end = body.find(",", i)
            end = len(body) if end < 0 else end
            piece = body[i:end].strip()
            if not piece:
                raise YamlSubsetError(f"empty flow sequence entry: [{body}]")
            items.append(resolve_plain(piece))
            rest = body[end:]
        if not rest:
            return items
        if rest[0] != ",":
            raise YamlSubsetError(f"expected ',' in flow sequence: [{body}]")
        i = len(body) - len(rest) + 1


def _split_key(content: str):
    """'key: value' -> (key, value text) if content is a mapping entry."""
    if content[:1] in ("'", '"'):
        key, end = _quoted(content, 0)
        rest = content[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", content)
    if m is None:
        return None
    key = content[:m.start()].strip()
    if key[:1] in ("[", "{", "?"):
        raise YamlSubsetError(f"complex keys are outside the subset: {content!r}")
    return resolve_plain(key), content[m.end():].strip()


def safe_load(text: str):
    """Parse ``text`` (the YAML subset above) as ``yaml.safe_load`` would."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tabs in indentation are not YAML")
        line = raw[:_find_comment(raw)].rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        if line.strip() in ("...",) or line.startswith("%"):
            raise YamlSubsetError(f"directives and document ends are outside the subset: {raw!r}")
        indent = len(line) - len(line.lstrip(" "))
        lines.append((indent, line.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise YamlSubsetError(f"unexpected content at line: {lines[end][1]!r}")
    return value


def _block(lines, i, indent):
    """The block node whose lines start at lines[i], indented by ``indent``."""
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        return _sequence(lines, i, indent)
    if _split_key(content) is not None:
        return _mapping(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1][0] >= indent:
        raise YamlSubsetError(f"multi-line plain scalars are outside the subset: {content!r}")
    return _scalar(content), i + 1


def _value(lines, i, indent, text, parent_indent, in_mapping):
    """The value of an entry whose inline text is ``text``; a block value
    starts on the next line, deeper than ``parent_indent`` (or, for a
    mapping's sequence, at the same indent)."""
    if text:
        return _scalar(text), i + 1
    nxt = i + 1
    if nxt < len(lines):
        n_indent, n_content = lines[nxt]
        if n_indent > parent_indent:
            return _block(lines, nxt, n_indent)
        if in_mapping and n_indent == parent_indent and (
                n_content == "-" or n_content.startswith("- ")):
            return _sequence(lines, nxt, n_indent)
    return None, nxt


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        entry = _split_key(lines[i][1])
        if entry is None:
            break
        key, text = entry
        if key in out:
            # pyyaml keeps the last; a config with a duplicate is a mistake
            raise YamlSubsetError(f"duplicate key {key!r}")
        out[key], i = _value(lines, i, indent, text, indent, in_mapping=True)
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        if not (content == "-" or content.startswith("- ")):
            break
        rest = content[1:].strip()
        if rest and (rest == "-" or rest.startswith("- ") or _split_key(rest) is not None) \
                and rest[:1] not in ("'", '"', "["):
            raise YamlSubsetError(f"compact nested collections are outside the subset: {content!r}")
        value, i = _value(lines, i, indent, rest, indent, in_mapping=False)
        out.append(value)
    return out, i


def _plain_ok(text: str) -> bool:
    """Whether pyyaml would write ``text`` as a plain scalar."""
    if not text or text != text.strip() or "\n" in text:
        return False
    if text[0] in "-?:,[]{}#&*!|>'\"%@`" or text.endswith(":"):
        return False
    if ": " in text or " #" in text or any(not c.isprintable() for c in text):
        return False
    try:
        return resolve_plain(text) == text
    except YamlSubsetError:
        return False


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        return value if _plain_ok(value) else "'" + value.replace("'", "''") + "'"
    raise YamlSubsetError(f"cannot write a {type(value).__name__} in the YAML subset")


def safe_dump(data: dict) -> str:
    """Write a mapping of scalars, lists of scalars and mappings in the block
    style of ``yaml.safe_dump(data, sort_keys=False)``."""
    out = []

    def mapping(d, indent):
        pad = " " * indent
        for key, value in d.items():
            head = f"{pad}{_dump_scalar(key)}:"
            if isinstance(value, dict) and value:
                out.append(head)
                mapping(value, indent + 2)
            elif isinstance(value, dict):
                out.append(head + " {}")
            elif isinstance(value, (list, tuple)) and value:
                out.append(head)
                for item in value:
                    if isinstance(item, (dict, list, tuple)):
                        raise YamlSubsetError("nested collections in a list are outside the subset")
                    out.append(f"{pad}- {_dump_scalar(item)}")
            elif isinstance(value, (list, tuple)):
                out.append(head + " []")
            else:
                out.append(f"{head} {_dump_scalar(value)}")

    mapping(data, 0)
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------- #
# the config schema
# --------------------------------------------------------------------------- #

class CfgNode(dict):
    """A dict with attribute access and recursive yaml merging."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_dict(self, other: dict, _path=""):
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"Unknown config key: {_path}{k}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Config key {_path}{k} expects a mapping")
                self[k].merge_from_dict(v, _path=f"{_path}{k}.")
            else:
                self[k] = v

    def merge_from_file(self, path: str):
        with open(path) as f:
            data = safe_load(f.read()) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts):
        if len(opts) % 2:
            raise AssertionError("merge_from_list expects KEY VALUE pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            old = node[parts[-1]]
            if not isinstance(old, (int, float, bool, list)):
                node[parts[-1]] = value
                continue
            new = safe_load(value)
            if isinstance(new, str) and isinstance(old, (int, float)) \
                    and not isinstance(old, bool):
                # YAML 1.1 reads bare scientific notation without a dot
                # ('1e-4') as a string; `TRAIN.OPTIM.LR 1e-4` is the common
                # spelling of an override, so retry it as a number
                try:
                    new = float(new) if isinstance(old, float) else int(new)
                except ValueError:
                    pass
            # typed keys reject mistyped values (`TRAIN.END_EPOCH sixty`)
            if isinstance(old, bool):
                ok = isinstance(new, bool)
            elif isinstance(old, float):
                ok = isinstance(new, (int, float)) and not isinstance(new, bool)
                new = float(new) if ok else new
            elif isinstance(old, int):
                ok = isinstance(new, int) and not isinstance(new, bool)
            else:
                ok = isinstance(new, list)
            if not ok:
                raise ValueError(
                    f"config key {key} expects {type(old).__name__}, "
                    f"got {value!r}")
            node[parts[-1]] = new

    def dump(self) -> str:
        def plain(d):
            return {k: plain(v) if isinstance(v, dict) else v for k, v in d.items()}

        return safe_dump(plain(self))


def _node(**kwargs) -> CfgNode:
    n = CfgNode()
    for k, v in kwargs.items():
        n[k] = v
    return n


def get_cfg_defaults() -> CfgNode:
    """The JAX package's schema and defaults, key for key."""
    cfg = _node(
        OUTPUT_DIR="results",
        EXP_NAME="default",
        DEVICE="tpu",
        DEBUG=True,
        LOGDIR="",
        NUM_WORKERS=8,
        DEBUG_FREQ=1000,
        SEED_VALUE=-1,
        SAVE_FREQ=5,
        # keep only the newest N epoch_N.pth.tar (-1 = keep all); model_best
        # is never pruned
        SAVE_KEEP_LAST=-1,
        # write epoch checkpoints on a background thread, from a CPU copy
        # taken first; False = synchronous
        SAVE_ASYNC=True,
        # the reference's cuDNN flags; the port sets torch.backends.cudnn from them
        CUDNN=_node(BENCHMARK=True, DETERMINISTIC=False, ENABLED=True),
        TRAIN=_node(
            DATASETS_2D=["insta"],
            DATASETS_3D=["mpii3d"],
            DATASETS_IMG=["coco2014-all"],
            DATASET_EVAL="ThreeDPW",
            BATCH_SIZE_3D=4,
            BATCH_SIZE_2D=4,
            BATCH_SIZE_IMG=8,
            IMG_USE_FREQ=1,
            START_EPOCH=0,
            END_EPOCH=5,
            RESUME="",
            NUM_ITERS_PER_EPOCH=-1,
            OPTIM=_node(
                OPTIM="Adam",
                LR=1e-4,
                WD=1e-4,
                MOMENTUM=0.9,
                WARMUP_EPOCH=2,
                WARMUP_FACTOR=0.1,
                MILESTONES=[10, 15],
                # k > 1 averages k calls' gradients into one update
                GRAD_ACCUM_STEPS=1,
            ),
        ),
        DATASET=_node(
            SEQLEN=20,
            OVERLAP=0.5,
            SAMPLE_POOL=64,
            SIZE_JITTER=0.2,
            ROT_JITTER=30,
            RANDOM_SAMPLE=True,
            RANDOM_START=False,
            RANDOM_FLIP=0.5,
            WIDTH=224,
            HEIGHT=224,
            RANDOM_CROP_P=0.0,
            RANDOM_CROP_SIZE=0.5,
            COLOR_JITTER=0.3,
            ERASE_PROB=0.3,
            ERASE_PART=0.7,
            ERASE_FILL=False,
            ERASE_KP=False,
            ERASE_MARGIN=0.2,
            # clips travel to the device as uint8 and the model normalizes
            # them there (ops/image.py::device_normalize)
            DEVICE_PREPROC=True,
            # raw frames + crop affines, the crop on the device: not ported
            DEVICE_CROP=False,
        ),
        LOSS=_node(
            KP_2D_W=60.0,
            KP_3D_W=30.0,
            SHAPE_W=0.001,
            POSE_W=1.0,
            SMPL_NORM=1.0,
            ACCL_W=0.0,
        ),
        MODEL=_node(
            DECODER=_node(BACKBONE="ktd", HIDDEN_DIM=1024),
            ENCODER=_node(
                BACKBONE="ste", NUM_BLOCKS=6, NUM_HEADS=12, SPA_TEMP_MODE="vanilla"
            ),
        ),
        EVAL=_node(SEQLEN=16, SAMPLE_POOL=128, BATCH_SIZE=32, INTERPOLATION=1),
    )
    return cfg


def update_cfg(cfg_file: str) -> CfgNode:
    cfg = get_cfg_defaults()
    cfg.merge_from_file(cfg_file)
    return cfg.clone()


def parse_args(argv=None):
    """The JAX CLIs' flags and ``KEY VALUE`` overrides: (args, cfg, cfg_file)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, help="cfg file path", default=None)
    parser.add_argument("--pretrained", type=str, default="",
                        help="stage 1 checkpoint file path")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="checkpoint to evaluate")
    parser.add_argument("--init_backbone", type=str, default="",
                        help="published encoder init (timm .npz or .pth)")
    parser.add_argument("--eval_ds", type=str, default="3dpw")
    parser.add_argument("--eval_set", type=str, default="test")
    parser.add_argument("--image_root", type=str, default="")
    parser.add_argument("--image_list", type=str, default="")
    parser.add_argument("--output_path", type=str, default="")
    parser.add_argument(
        "--allow_synthetic_smpl", action="store_true",
        help="permit running without the real SMPL body model files "
             "(metrics computed against a RANDOM body are meaningless; "
             "only useful for smoke tests)")
    parser.add_argument(
        "opts", nargs="*", default=[],
        help="KEY VALUE config overrides applied after --cfg, e.g. "
             "`TRAIN.RESUME auto TRAIN.END_EPOCH 60`")
    args = parser.parse_args(argv)

    if args.cfg is not None:
        # a missing file is an error, never a silent run of the defaults
        if not osp.isfile(args.cfg):
            parser.error(f"--cfg file not found: {args.cfg}")
        cfg = update_cfg(args.cfg)
    else:
        cfg = get_cfg_defaults()
    if args.opts:
        try:
            cfg.merge_from_list(args.opts)
        except (KeyError, ValueError, AssertionError) as e:
            parser.error(f"bad KEY VALUE overrides: {e}")
    return args, cfg, args.cfg
