"""HTTP retrieval server over a descriptor index, on the PyTorch port.

Wraps openibl_tpu_torch.serving.RetrievalService (model warm, index resident
on the device) in the same stdlib HTTP handler as examples/serve.py:

  python examples/serve_torch.py index.npz --weights w.pth --port 8080
  python examples/serve_torch.py index.npz --device cpu   # no GPU

  GET  /healthz            -> {"ok": true, "index_size": N}
  POST /query?topk=5       -> body = image bytes (jpeg/png/...);
                              response = JSON match list
"""

import argparse
import os.path as osp
import sys
from http.server import ThreadingHTTPServer

_HERE = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, osp.join(_HERE, ".."))
sys.path.insert(0, _HERE)

from serve import make_handler  # noqa: E402  (stdlib-only module top)


def main():
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
    args = p.parse_args()

    from openibl_tpu_torch.serving import RetrievalService

    service = RetrievalService(args.index, weights=args.weights,
                               height=args.height, width=args.width,
                               quantize_int8=args.int8,
                               ivf_nprobe=args.ivf_nprobe,
                               pca_params=args.pca_params,
                               quant_backbone=args.quant_backbone,
                               use_pq=args.pq, pq_rerank=args.pq_rerank,
                               device=args.device)
    print(f"warming {len(service.buckets)} batch buckets over "
          f"{service.index_size}-image index on {service.device} ...")
    service.warmup()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving on http://{args.host}:{args.port}  (POST /query, "
          f"GET /healthz)")
    server.serve_forever()


if __name__ == "__main__":
    main()
