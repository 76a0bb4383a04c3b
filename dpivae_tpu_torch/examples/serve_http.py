"""A minimal HTTP host for a serving artifact (counterpart of
examples/serve_http.py).

Loads a ``dpivae_tpu_torch.serving.save_predictor`` artifact (a
``torch.export`` program and its sidecar: no model code, case or
checkpoint) and serves it over HTTP with the standard library alone:

    python -m dpivae_tpu_torch.examples.serve_http \\
        --artifact output/run/models/predictor.pt2 --port 8787 [--device cpu]

    GET  /meta      -> the artifact's .meta.json sidecar
    POST /predict   -> {"x": [[...]], "c": [[...]], "seed": 0}
                       => {"y": [[...]], ...the named outputs}

The batch dimension is symbolic in the artifact, so one program serves
any request size. The host is a ``ThreadingHTTPServer``, one handler
thread per connection: each request seeds its own ``torch.Generator``,
and the program's module is built once before the first request, so
concurrent requests answer as serial ones do. A request whose JSON or
widths do not fit the sidecar gets a 400. This is a demo host: no
authentication and no request limits.

``--device`` defaults to CUDA and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np


def _rows(req: dict, name: str, width: int) -> np.ndarray:
    a = np.asarray(req[name], np.float32)
    if a.ndim != 2 or a.shape[0] < 1 or a.shape[1] != width:
        raise ValueError(f"{name} must be (batch >= 1, {width}); got "
                         f"{a.shape}")
    return a


def make_handler(served):
    """The request handler class for ``served`` (a ``ServedPredictor``)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/meta":
                self._send(200, served.meta)
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                if not isinstance(req, dict):
                    raise ValueError("the request must be a JSON object")
                x = _rows(req, "x", served.meta["nd_x"])
                c = _rows(req, "c", served.meta["nd_c"])
                if x.shape[0] != c.shape[0]:
                    raise ValueError(f"x has {x.shape[0]} rows, c "
                                     f"{c.shape[0]}")
                seed = int(req.get("seed", 0))
            except (KeyError, ValueError, TypeError) as e:
                # json.JSONDecodeError is a ValueError
                self._send(400, {"error": str(e)})
                return
            out = served(x, c, seed=seed)
            self._send(200, {name: v.tolist() for name, v in out.items()})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(served, host: str = "127.0.0.1",
          port: int = 8787) -> ThreadingHTTPServer:
    """Serve ``served`` on ``host:port`` (port 0 takes a free one) from a
    background thread. Returns the server: its ``server_address`` holds
    the bound port, and ``shutdown()`` then ``server_close()`` stop it."""
    # Build the program's module now: the lazy build on a first call is
    # not guarded against two handler threads racing to it.
    served._module
    server = ThreadingHTTPServer((host, port), make_handler(served))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="serve_http",
                     daemon=True).start()
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--artifact", required=True,
                        help="path to a save_predictor .pt2 artifact")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from dpivae_tpu_torch.serving import load_predictor

    served = load_predictor(args.artifact, device=args.device)
    server = serve(served, args.host, args.port)
    print(f"serving {args.artifact} (outputs={list(served.outputs)}) on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
