"""Minimal HTTP serving host for exported artifacts (port of
scripts/serve_http.py; standard library, torch, numpy and PIL only).

A serving host needs torch and the artifact file, none of this package's
code. POST a PNG image to /predict and receive the label map as a PNG
(mode L); GET /healthz returns the artifact's metadata.

    python -m cutmix_seg_tpu_torch.serve.http --artifact model_321.pt2 --port 8321
    curl -s --data-binary @street.png localhost:8321/predict > labels.png

The program has a symbolic batch dimension; this host serves batch 1 per
request, on the device the artifact was exported on.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_handler(call, meta):
    import numpy as np
    import torch
    from PIL import Image

    hw = tuple(meta["input_hw"]) if meta else None
    # the program runs where its weights live
    device = next(iter(call.state_dict().values())).device

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, body: bytes, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._reply(json.dumps(meta or {}).encode(), "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            img = Image.open(io.BytesIO(self.rfile.read(n))).convert("RGB")
            if hw is not None and img.size != (hw[1], hw[0]):
                # serve at the artifact's static resolution
                img = img.resize((hw[1], hw[0]), Image.BILINEAR)
            x = torch.from_numpy(np.asarray(img, dtype=np.uint8)[None].copy()).to(device)
            pred = call(x)[0].to(torch.uint8).cpu().numpy()
            buf = io.BytesIO()
            Image.fromarray(pred, mode="L").save(buf, format="PNG")
            self._reply(buf.getvalue(), "image/png")

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)

    import torch

    # torch-only load: the serving host does not need the package
    call = torch.export.load(args.artifact).module()
    meta = None
    try:
        with open(args.artifact + ".json") as f:
            meta = json.load(f)
    except FileNotFoundError:
        pass

    server = ThreadingHTTPServer((args.host, args.port), make_handler(call, meta))
    print(f"serving {args.artifact} on {args.host}:{server.server_address[1]}",
          file=sys.stderr, flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
