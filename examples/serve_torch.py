"""HTTP retrieval server over a descriptor index, on the PyTorch port.

Wraps openibl_tpu_torch.serving.RetrievalService (model warm, index resident
on the device) in a stdlib HTTP server, with the routes of
examples/serve.py:

  python examples/serve_torch.py index.npz --weights w.pth --port 8080
  python examples/serve_torch.py index.npz --device cpu   # no GPU
  torchrun --nproc-per-node=4 examples/serve_torch.py index.npz \
      --n-devices 4 --pq                                  # index over 4 GPUs

  GET  /healthz            -> {"ok": true, "index_size": N}
  POST /query?topk=5       -> body = image bytes (jpeg/png/...);
                              response = JSON match list

With ``--n-devices N`` under ``torchrun`` (or Slurm, one task a GPU) the
index is split over the N ranks; rank 0 runs the model and the HTTP
server, the other ranks search their shards in lockstep with it. SIGTERM
or Ctrl-C on rank 0 closes the service, and every rank exits 0.
"""

import argparse
import io
import json
import os
import os.path as osp
import signal
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def make_handler(service):
    """The request handler class over ``service`` (GET /healthz, POST
    /query): a bad request is a 400, a failure of the device or the model
    a 500."""

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                return self._json(
                    200, {"ok": True, "index_size": service.index_size})
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/query":
                return self._json(404, {"error": "unknown path"})
            try:
                topk = int(parse_qs(url.query).get("topk", ["10"])[0])
                length = int(self.headers.get("Content-Length", 0))
                from PIL import Image

                img = Image.open(io.BytesIO(self.rfile.read(length)))
            except Exception as e:  # noqa: BLE001 - malformed request
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                matches = service.query([img], topk=topk)[0]
            except ValueError as e:  # bad image shape/dtype = client error
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - device/model failure:
                # a 500 so load balancers retry or alert instead of
                # treating a backend outage as a bad request
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return self._json(200, {"matches": matches})

        def log_message(self, fmt, *args):  # quiet default access log
            pass

    return Handler


def _stop_on_sigterm():
    """SIGTERM ends ``serve_forever`` as Ctrl-C does."""
    def handler(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, handler)


def _follow(service):
    """A follower rank: ignore the signals a launcher forwards to every
    rank (rank 0's close() ends the loop), then follow."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    service.follow()


def main(argv=None):
    p = argparse.ArgumentParser(description="retrieval HTTP server (PyTorch)")
    p.add_argument("index", help="index .npz from index_and_query.py build")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--pca-params", type=str, default=None,
                   help="PCA-whitening .h5/.npz for trainer checkpoints "
                        "(auto-discovered next to the checkpoint if omitted)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--n-devices", type=int, default=0,
                   help=">0 splits the index over that many GPUs, one "
                        "process each (launch with torchrun "
                        "--nproc-per-node=N)")
    p.add_argument("--int8", action="store_true",
                   help="quantize a float index to int8 at load")
    p.add_argument("--ivf-nprobe", type=int, default=0,
                   help=">0 probes only that many IVF cells per query "
                        "(approximate; index built with --ivf-nlist)")
    p.add_argument("--pq", action="store_true",
                   help="serve from the index's product-quantized codes "
                        "(build --pq-m; exhaustive ADC, kernel K2 on CUDA). "
                        "Implied for --pq-only indexes; with --ivf-nprobe "
                        "IVFADC (residual codes, probed cell by cell)")
    p.add_argument("--pq-rerank", type=int, default=0,
                   help=">0 = ADC shortlist of this size over the PQ codes, "
                        "re-ranked exactly against the full-width "
                        "descriptors (index built with --pq-m, without "
                        "--pq-only)")
    p.add_argument("--quant-backbone", action="store_true",
                   help="run the conv backbone mixed float/int8 "
                        "(openibl_tpu_torch/ops/quant.py: conv2_1..conv5_3 "
                        "through the int8 kernel K3 on CUDA), calibrated "
                        "on random noise (a warning says so)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for the model and the index")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from openibl_tpu_torch.parallel.mesh import (get_mesh,
                                                 maybe_init_distributed)
    from openibl_tpu_torch.serving import RetrievalService

    mesh = None
    if args.n_devices:
        maybe_init_distributed(args.device)
        mesh = get_mesh(args.n_devices, device=args.device)
    try:
        service = RetrievalService(args.index, weights=args.weights,
                                   height=args.height, width=args.width,
                                   mesh=mesh, quantize_int8=args.int8,
                                   ivf_nprobe=args.ivf_nprobe,
                                   pca_params=args.pca_params,
                                   quant_backbone=args.quant_backbone,
                                   use_pq=args.pq, pq_rerank=args.pq_rerank,
                                   device=args.device)
        if not service.leader:
            _follow(service)
            return
        _stop_on_sigterm()
        print(f"warming {len(service.buckets)} batch buckets over "
              f"{service.index_size}-image index on {service.device}"
              + (f", split over {mesh.size} ranks" if mesh else "")
              + " ...", flush=True)
        try:
            service.warmup()
            server = ThreadingHTTPServer((args.host, args.port),
                                         make_handler(service))
            print(f"serving on http://{args.host}:{args.port}  (POST "
                  f"/query, GET /healthz; pid {os.getpid()})", flush=True)
            try:
                server.serve_forever()
            finally:
                server.server_close()
        except KeyboardInterrupt:
            print("stopping", flush=True)
        finally:
            service.close()
    finally:
        if mesh is not None and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
