"""Serving throughput end to end: HTTP client -> serving host -> device.

Port of the JAX package's ``tools/bench_serve.py``. It measures what a
deployment delivers: the npy request, the HTTP hop, the host's dispatch,
the forward and the npz answer. With ``--artifact`` it starts its own host
(``maed_tpu_torch.serve``) in this process, as the JAX tool does; with
``--url`` it sends to a host already running. The requests are full batches
in the artifact's input dtype, made from a seed: uint8 frames for a u8
artifact (the JAX tool fed float32 noise, which the port's host refuses
for a u8 artifact), ImageNet-normalized float32 for an f32 one.

    python -m maed_tpu_torch.utils.export --cfg ... --out m.pt2
    python -m maed_tpu_torch.tools.bench_serve --artifact m.pt2 [--iters 20]
    python -m maed_tpu_torch.tools.bench_serve --url http://127.0.0.1:8700

Prints one JSON line: {"metric": "serve_clips_per_s", ...} with the card's
name and power limit as nvidia-smi reports them (null without nvidia-smi).
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import threading
import time
from urllib.parse import urlparse

import numpy as np

from maed_tpu_torch.utils.timing import card_identity


def request_body(spec: dict, seed: int = 0) -> bytes:
    """One full batch in the artifact's dtype, as .npy bytes."""
    rng = np.random.RandomState(seed)
    shape = (spec["batch"], spec["seqlen"], spec["height"], spec["width"], 3)
    if spec["dtype"] == "uint8":
        images = rng.randint(0, 256, shape, dtype=np.uint8)
    else:
        images = rng.randn(*shape).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, images)
    return buf.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    where = ap.add_mutually_exclusive_group(required=True)
    where.add_argument("--artifact", help="start a host over this artifact in this process")
    where.add_argument("--url", help="a running host, e.g. http://127.0.0.1:8700")
    ap.add_argument("--params", default="", help="args-mode .params.npz (with --artifact)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)

    server = None
    if args.artifact:
        from http.server import ThreadingHTTPServer

        from maed_tpu_torch.serve import ModelHost, make_handler

        host = ModelHost(args.artifact, args.params)
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(host))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        address = ("127.0.0.1", server.server_address[1])
    else:
        url = urlparse(args.url)
        address = (url.hostname, url.port or 80)

    conn = http.client.HTTPConnection(*address, timeout=600)
    try:
        conn.request("GET", "/healthz")
        spec = json.loads(conn.getresponse().read())
        body = request_body(spec)

        def once():
            conn.request("POST", "/predict", body=body)
            r = conn.getresponse()
            payload = r.read()
            if r.status != 200:
                raise RuntimeError(f"/predict answered {r.status}: {payload[:200]!r}")
            return payload

        for _ in range(args.warmup):
            once()
        lat = []
        t0 = time.perf_counter()
        for _ in range(args.iters):
            s = time.perf_counter()
            once()
            lat.append(time.perf_counter() - s)
        wall = time.perf_counter() - t0
    finally:
        conn.close()
        if server is not None:
            server.shutdown()
            server.server_close()

    print(json.dumps({
        "metric": "serve_clips_per_s", "value": spec["batch"] * args.iters / wall,
        "unit": "clips/s", "median_latency_ms": 1000 * float(np.median(lat)),
        "p90_latency_ms": 1000 * float(np.percentile(lat, 90)),
        "batch": spec["batch"], "seqlen": spec["seqlen"], "dtype": spec["dtype"],
        "request_bytes": len(body), "iters": args.iters, "card": card_identity(),
    }), flush=True)


if __name__ == "__main__":
    main()
