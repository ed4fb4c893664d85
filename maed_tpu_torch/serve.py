"""Serving host: an HTTP inference server over an exported artifact.

Port of the JAX package's ``serve.py``. ``maed_tpu_torch.utils.export``
makes the artifact (weights baked, or args mode with a ``.params.npz`` side
file); this host is the endpoint around it: the standard library's
``http.server``, and no model, config or checkpoint code in the process
(it imports ``utils.export`` and, through it, the kernels' operators).

    python -m maed_tpu_torch.utils.export --cfg ... --out m.pt2 --batch 8 2
    python -m maed_tpu_torch.serve --artifact m.pt2 m.pt2.b2 [--port 8700]

Protocol (shapes are static: one artifact per (batch, seqlen)):
  GET  /healthz  -> JSON {batch, seqlen, height, width, dtype, device, ...,
                    ready}; with several artifacts also {buckets}
  POST /predict  -> body: .npy bytes, images (B, T, H, W, 3) of the
                    artifact's dtype (uint8 raw crops for a u8 artifact,
                    ImageNet-normalized float32 for an f32 one). B <= the
                    exported batch: the host pads to it and trims the
                    answer. Response: .npz bytes with theta (B, T, 85),
                    verts, kp_2d, kp_3d, rotmat.
  400 on a bad shape or a dtype other than the artifact's (the JAX host
  casts instead), 503 while the warmup runs, 500 on any other failure.

Requests are served one at a time behind a lock: one program, one device;
throughput comes from the exported batch. SIGTERM and SIGINT shut the
server down gracefully.
"""

from __future__ import annotations

import argparse
import io
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from maed_tpu_torch.utils.export import OUT_KEYS, load_exported


class ModelHost:
    """Loads the artifact, holds the dispatch lock, pads and trims the batch."""

    def __init__(self, artifact_path: str, params_path: str = ""):
        self.fwd = load_exported(artifact_path)
        self.params = None
        if self.fwd.takes_params:
            with np.load(params_path or artifact_path + ".params.npz") as npz:
                self.params = self.fwd.place_params(dict(npz))
        self.batch, self.seqlen, self.height, self.width = self.fwd.shape[:4]
        self.img_dtype = np.dtype(self.fwd.spec["dtype"])
        self._lock = threading.Lock()

    def spec(self) -> dict:
        s = self.fwd.spec
        return {"batch": self.batch, "seqlen": self.seqlen, "height": self.height,
                "width": self.width, "dtype": self.img_dtype.name, "device": s["device"],
                "device_name": s["device_name"], "torch": s["torch"], "outputs": s["outputs"]}

    def warmup(self):
        """One request of zeros: the kernels' library is built (or loaded)
        and Triton compiles here, not in the first client's request."""
        self.predict(np.zeros((1, self.seqlen, self.height, self.width, 3), self.img_dtype))

    def predict(self, images: np.ndarray) -> dict:
        want = (self.seqlen, self.height, self.width, 3)
        if images.ndim != 5 or images.shape[1:] != want:
            raise ValueError(f"images must be (B<={self.batch}, {want[0]}, {want[1]}, "
                             f"{want[2]}, 3), got {images.shape}")
        if images.dtype != self.img_dtype:
            raise ValueError(f"images must be {self.img_dtype.name} for this artifact, got "
                             f"{images.dtype.name}")
        n = images.shape[0]
        if not 1 <= n <= self.batch:
            raise ValueError(f"batch {n} outside [1, {self.batch}]")
        if n < self.batch:  # pad to the exported static shape
            pad = np.zeros((self.batch - n,) + want, self.img_dtype)
            images = np.concatenate([images, pad], axis=0)
        with self._lock:
            out = self.fwd(self.params, images) if self.params is not None else self.fwd(images)
            return {k: out[k][:n].cpu().numpy() for k in OUT_KEYS}


class BucketedHost:
    """Routes each request to the smallest exported batch that fits: a small
    request does not pay for the largest batch's work."""

    def __init__(self, artifact_paths, params_path: str = ""):
        hosts = [ModelHost(p, params_path) for p in artifact_paths]
        self.hosts = sorted(hosts, key=lambda h: h.batch)
        keys = ("seqlen", "height", "width", "dtype", "device")
        ref = self.hosts[0].spec()
        for h in self.hosts[1:]:
            s = h.spec()
            if {k: s[k] for k in keys} != {k: ref[k] for k in keys}:
                raise ValueError(f"bucket specs differ beyond batch: {s} vs {ref}")
        self.batch = self.hosts[-1].batch

    def spec(self) -> dict:
        top = self.hosts[-1].spec()
        top["buckets"] = [h.batch for h in self.hosts]
        return top

    def warmup(self):
        for h in self.hosts:
            h.warmup()

    def predict(self, images: np.ndarray) -> dict:
        n = images.shape[0] if getattr(images, "ndim", 0) >= 1 else 0
        for h in self.hosts:
            if n <= h.batch:
                return h.predict(images)
        return self.hosts[-1].predict(images)  # raises the batch error


def make_handler(host, ready: threading.Event | None = None):
    """The request handler over ``host``. Until ``ready`` is set, /healthz
    says {"ready": false} and /predict answers 503 (the warmup runs)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; the CLI prints the endpoint once
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                spec = dict(host.spec(), ready=ready is None or ready.is_set())
                self._send(200, json.dumps(spec).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)  # read it all, whatever the answer
            if ready is not None and not ready.is_set():
                self._send(503, b"warming up", "text/plain")
                return
            try:
                images = np.load(io.BytesIO(body), allow_pickle=False)
                preds = host.predict(np.asarray(images))
                buf = io.BytesIO()
                np.savez(buf, **preds)
                self._send(200, buf.getvalue(), "application/octet-stream")
            except ValueError as e:
                self._send(400, str(e).encode(), "text/plain")
            except Exception as e:  # noqa: BLE001 — the serving loop must survive
                self._send(500, f"{type(e).__name__}: {e}".encode(), "text/plain")

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", required=True, nargs="+",
                    help="artifact(s) of maed_tpu_torch.utils.export; several -> a bucketed "
                    "server that routes each request to the smallest batch that fits")
    ap.add_argument("--params", default="",
                    help="args-mode .params.npz (default: <artifact>.params.npz)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700, help="0: any free port")
    args = ap.parse_args(argv)

    host = (ModelHost(args.artifact[0], args.params) if len(args.artifact) == 1
            else BucketedHost(args.artifact, args.params))
    print(f"loaded {args.artifact}: {host.spec()}", flush=True)

    # bind and answer /healthz at once; /predict answers 503 until the warmup is done
    ready, stop = threading.Event(), threading.Event()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(host, ready))
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print(f"serving on http://{args.host}:{server.server_address[1]} (warming up)", flush=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host.warmup()
    ready.set()
    print("warmup done: ready", flush=True)
    stop.wait()
    server.shutdown()
    server.server_close()
    print("shut down", flush=True)


if __name__ == "__main__":
    main()
