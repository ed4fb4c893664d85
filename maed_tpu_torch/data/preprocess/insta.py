"""InstaVariety preprocessor: tfrecords -> frame JPEGs + annotation DB.

    python -m maed_tpu_torch.data.preprocess.insta --extract_imgs   # tfrecord -> JPEGs
    python -m maed_tpu_torch.data.preprocess.insta                  # build the DB

Port of ``maed_tpu/data/preprocess/insta.py``. The TFRecord and
tf.train.Example readers are ``struct`` only, unchanged (no TensorFlow).
:func:`extract_images` writes each record's JPEG bytes to
``frame_%06d.jpg`` as they are, after checking that they decode
(``utils/image_io.py``), where the JAX package decodes and re-encodes them
through cv2: the port has no JPEG encoder, and the stored frame is the
source's own. The DB is written with joblib where it is installed, else as
a plain pickle.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import struct

import numpy as np

from maed_tpu_torch.data.keypoints import convert_kps


# ----------------------------------------------------------------------
# Minimal TFRecord + tf.train.Example reader (no TensorFlow dependency)
# ----------------------------------------------------------------------

def iter_tfrecord(path: str):
    """Yields raw record bytes from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            data = f.read(length)
            f.read(4)  # data crc
            yield data


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf):
    """Parse a protobuf message into {field_number: [wire values]}."""
    fields = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        fields.setdefault(fnum, []).append(val)
    return fields


def parse_example(record: bytes):
    """tf.train.Example -> {name: list/array} for bytes/float/int64 features."""
    example = _parse_fields(record)
    features = _parse_fields(example[1][0])  # Example.features
    out = {}
    for feat_msg in features.get(1, []):  # Features.feature (map entries)
        entry = _parse_fields(feat_msg)
        name = entry[1][0].decode()
        feature = _parse_fields(entry[2][0])
        if 1 in feature:  # bytes_list
            bl = _parse_fields(feature[1][0])
            out[name] = bl.get(1, [])
        elif 2 in feature:  # float_list
            fl = _parse_fields(feature[2][0])
            if 1 in fl:
                raw = fl[1]
                if len(raw) == 1 and isinstance(raw[0], (bytes, bytearray)):
                    out[name] = np.frombuffer(raw[0], "<f4")
                else:
                    out[name] = np.array(
                        [struct.unpack("<f", v)[0] if isinstance(v, bytes) else v
                         for v in raw], np.float32,
                    )
            else:
                out[name] = np.zeros(0, np.float32)
        elif 3 in feature:  # int64_list
            il = _parse_fields(feature[3][0])
            raw = il.get(1, [])
            if len(raw) == 1 and isinstance(raw[0], (bytes, bytearray)):
                vals = []
                pos = 0
                while pos < len(raw[0]):
                    v, pos = _read_varint(raw[0], pos)
                    vals.append(v)
                out[name] = np.array(vals, np.int64)
            else:
                out[name] = np.array(raw, np.int64)
    return out


# ----------------------------------------------------------------------

def extract_images(inp_dir: str, img_out_dir: str, split: str = "train"):
    """Write the per-frame JPEGs of the tfrecords, each record's bytes as
    they are, once they are checked to decode."""
    from maed_tpu_torch import native

    records = sorted(glob.glob(osp.join(inp_dir, f"{split}_*.tfrecord")) +
                     glob.glob(osp.join(inp_dir, split, "*.tfrecord")))
    for rec_path in records:
        vid_base = osp.splitext(osp.basename(rec_path))[0]
        for vid_i, record in enumerate(iter_tfrecord(rec_path)):
            ex = parse_example(record)
            images = ex.get("image_data", [])
            out_dir = osp.join(img_out_dir, f"{vid_base}_{vid_i}")
            os.makedirs(out_dir, exist_ok=True)
            for f_i, jpg in enumerate(images):
                path = osp.join(out_dir, f"frame_{f_i:06d}.jpg")
                try:
                    native.decode(jpg)
                except IOError as e:
                    raise IOError(f"{rec_path} record {vid_i} frame {f_i}: {e} (the port "
                                  "decodes JPEG frames only)") from e
                with open(path, "wb") as f:
                    f.write(jpg)
            print(f"{vid_base}_{vid_i}: {len(images)} frames")


def read_data(inp_dir: str, img_dir: str, split: str = "train"):
    """Build the annotation DB from tfrecord keypoints (25-joint insta set)."""
    dataset = {"vid_name": [], "frame_id": [], "joints2D": [], "img_name": []}

    records = sorted(glob.glob(osp.join(inp_dir, f"{split}_*.tfrecord")) +
                     glob.glob(osp.join(inp_dir, split, "*.tfrecord")))
    for rec_path in records:
        vid_base = osp.splitext(osp.basename(rec_path))[0]
        for vid_i, record in enumerate(iter_tfrecord(rec_path)):
            ex = parse_example(record)
            xys = ex.get("image/xys", None)
            vis = ex.get("image/visibilities", None)
            if xys is None or vis is None:
                continue
            n_frames = len(ex.get("image_data", [])) or (
                len(vis) // 25 if vis is not None else 0
            )
            if n_frames == 0:
                continue
            xys = np.asarray(xys).reshape(n_frames, 2, 25).transpose(0, 2, 1)
            vis = np.asarray(vis).reshape(n_frames, 25, 1)
            kp = np.concatenate([xys, vis], axis=2)
            kp = convert_kps(kp, src="insta", dst="spin")

            name = f"{vid_base}_{vid_i}"
            paths = np.array([
                osp.join(img_dir, name, f"frame_{i:06d}.jpg") for i in range(n_frames)
            ])
            dataset["vid_name"].append(np.array([name] * n_frames))
            dataset["frame_id"].append(np.arange(n_frames))
            dataset["joints2D"].append(kp)
            dataset["img_name"].append(paths)

    for k in dataset:
        dataset[k] = np.concatenate(dataset[k])
    return dataset


def main(argv=None):
    from maed_tpu_torch.core import config as cfg_mod
    from maed_tpu_torch.data.dataset import save_db

    parser = argparse.ArgumentParser()
    parser.add_argument("--inp_dir", type=str, default=cfg_mod.INSTA_DIR)
    parser.add_argument("--img_dir", type=str, default=cfg_mod.INSTA_IMG_DIR)
    parser.add_argument("--out_dir", type=str, default=cfg_mod.DB_DIR)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--extract_imgs", action="store_true")
    args = parser.parse_args(argv)

    if args.extract_imgs:
        extract_images(args.inp_dir, args.img_dir, args.split)
        return
    db = read_data(args.inp_dir, args.img_dir, args.split)
    save_db(db, osp.join(args.out_dir, f"insta_{args.split}_db.pt"))
    print(f"wrote insta_{args.split}_db.pt: {len(db['img_name'])} frames")


if __name__ == "__main__":
    main()
