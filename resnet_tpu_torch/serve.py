"""HTTP inference server over a model saved by ``export.save_inference``.

The counterpart of tools/serve.py, with the same contract:

    python -m resnet_tpu_torch.serve /path/model.pt --port 8000 --device cuda

    POST /predict   body: raw float32 NHWC tensor bytes,
                    headers: X-Shape: "4,224,224,3"
                    -> JSON {"top1": [...], "logits_shape": [...],
                             "latency_ms": ...}
    GET  /healthz   -> {"ok": true}

Batching: requests are padded up to the next power-of-two bucket (capped at
--max-bucket) and the logits sliced back, so the device sees a bounded set
of batch shapes; requests above the cap are split into cap-size chunks
(--no-bucketing runs every request at its own size). The handler is
threaded (ThreadingHTTPServer); concurrent requests queue on the device.
The device is named, never guessed: ``--device cuda`` is the default.
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .export import load_inference


def bucketed_call(served, x: np.ndarray, max_bucket: int = 64) -> np.ndarray:
    """Pad the batch to the next power-of-two bucket (<= max_bucket), call,
    slice. Oversize batches are chunked at max_bucket."""
    n = x.shape[0]
    if n > max_bucket:
        parts = [
            bucketed_call(served, x[i:i + max_bucket], max_bucket)
            for i in range(0, n, max_bucket)
        ]
        return np.concatenate(parts, axis=0)
    b = 1
    while b < n:
        b *= 2
    # a non-power-of-two cap is itself the largest bucket
    b = min(b, max_bucket)
    if b > n:
        x = np.concatenate([x, np.zeros((b - n,) + x.shape[1:], x.dtype)], axis=0)
    return served.call(x).cpu().numpy()[:n]


def make_handler(served):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                shape = tuple(int(s) for s in self.headers["X-Shape"].split(","))
                n = int(self.headers["Content-Length"])
                x = np.frombuffer(self.rfile.read(n), dtype=np.float32).reshape(shape)
            except (TypeError, ValueError, AttributeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            t0 = time.perf_counter()
            try:
                if self.server.max_bucket:
                    logits = bucketed_call(served, x, self.server.max_bucket)
                else:
                    logits = served.call(x).cpu().numpy()
            except ValueError as e:  # a shape the model does not take
                self._reply(400, {"error": f"inference failed: {e}"})
                return
            ms = (time.perf_counter() - t0) * 1000.0
            self._reply(200, {
                "top1": logits.argmax(-1).tolist(),
                "logits_shape": list(logits.shape),
                "latency_ms": round(ms, 2),
            })

        def log_message(self, *a):  # quiet; the caller owns logging
            pass

    return Handler


def serve(artifact_path: str, host: str = "127.0.0.1", port: int = 8000,
          max_bucket: int = 64, device="cuda") -> ThreadingHTTPServer:
    """Load the model on ``device`` and return an unstarted server; its
    ``served`` attribute is the loaded model."""
    served = load_inference(artifact_path, device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(served))
    httpd.max_bucket = max_bucket  # 0 = every request at its own size
    httpd.served = served
    return httpd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-bucket", type=int, default=64,
                    help="pad requests up to power-of-two buckets capped"
                         " here; 0 disables")
    ap.add_argument("--no-bucketing", dest="max_bucket",
                    action="store_const", const=0)
    args = ap.parse_args()
    httpd = serve(args.artifact, args.host, args.port,
                  max_bucket=args.max_bucket, device=args.device)
    print(f"serving {args.artifact} on {args.host}:{httpd.server_address[1]}"
          f" ({args.device})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
