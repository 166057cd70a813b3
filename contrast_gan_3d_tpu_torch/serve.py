"""Serve full-volume contrast correction over HTTP (the port's counterpart
of the JAX package's ``scripts/serve.py``):

    python -m contrast_gan_3d_tpu_torch.serve runs/exp1 --warmup-shape 512 512 128

loads a trained generator (the latest ``<step>.pt`` of a run directory, or
that file; a reference ``<iteration>.pt`` with ``--reference-pt``) or a
correction artifact (a ``.pt2corr`` file or a bundle directory of them,
``export_corrector``, with ``--artifact``), and serves ``POST /correct``
(npy in, npy out), ``GET /healthz`` and ``GET /stats``
(``serving.CorrectionServer``; client ``serving.correct_remote``). The
defaults are the JAX command's: 128^3 patches at overlap 0.25, bf16,
``--z-bucket 64``, the corrector's layout and batch ("auto": the packed
window at batch 24 for a 3D batch-norm generator), port 8390 on every
interface, 4 requests in flight. Runs on the card unless ``--device cpu``.
SIGTERM or Ctrl-C drains the requests in flight and exits; a second one
aborts the drain. ``--dp-devices N`` splits each volume's patch grid over
the first N cards (``CCTAContrastCorrector.shard_over``; on the CPU, N
shares of it): 3D checkpoints only, not ``--artifact`` (an artifact is one
exported single-device program) and not 2D, as in JAX.
"""

import argparse
import logging
import threading
from pathlib import Path

import torch

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.export import ArtifactBundle, load_exported_corrector
from contrast_gan_3d_tpu_torch.parallel.inference import local_devices
from contrast_gan_3d_tpu_torch.serving import CorrectionServer
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="run dir or <step>.pt, a reference .pt with --reference-pt, or a .pt2corr "
                                      "artifact or bundle dir with --artifact")
    p.add_argument("--reference-pt", action="store_true", help="checkpoint is a reference torch .pt file")
    p.add_argument("--artifact", action="store_true",
                   help="checkpoint is a .pt2corr correction artifact (export_corrector) or a directory of them; "
                        "no model code or tracing; serves exactly the exported volume shapes")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8390)
    p.add_argument("--patch", type=int, nargs="+", default=(128, 128, 128),
                   help="inference patch size: W H D (3D sliding window) or W H (2D family, slice-batched)")
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--batch", type=int, default=None, help="patches per forward (default: the corrector's choice)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16",
                   help="compute dtype (float32 = strict-parity serving)")
    p.add_argument("--z-bucket", type=int, default=64,
                   help="pad volume z to this multiple before correcting (bounds the distinct shapes a mixed-z "
                        "cohort dispatches; 0 = off)")
    p.add_argument("--warmup-shape", type=int, nargs=3, default=None,
                   help="correct zeros of this volume shape once before serving (e.g. 512 512 128)")
    p.add_argument("--max-inflight", type=int, default=4,
                   help="max concurrent requests holding volume bytes in host memory (held through the response "
                        "write); the excess queues before reading its body (default 4, min 1)")
    p.add_argument("--dp-devices", type=int, default=None,
                   help="shard each volume's patch grid over the first N cards (3D checkpoints only, not "
                        "--artifact / 2D)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if len(args.patch) not in (2, 3):
        p.error("--patch takes W H D (3D) or W H (2D)")
    if args.max_inflight < 1:
        p.error("--max-inflight must be >= 1 (the cap is the host-memory bound; 0 would block every request)")
    if args.dp_devices is not None:
        if args.artifact:
            p.error("--dp-devices needs the live corrector; a correction artifact is exported for one device")
        if len(args.patch) == 2:
            p.error("--dp-devices applies to the 3D sliding window only")
        if args.dp_devices < 1:
            p.error("--dp-devices must be >= 1")
        if args.device != "cpu" and torch.cuda.is_available() and args.dp_devices > torch.cuda.device_count():
            p.error(f"--dp-devices {args.dp_devices}: only {torch.cuda.device_count()} CUDA devices are visible")
    return args


def build_server(args) -> CorrectionServer:
    """The corrector the arguments name, warmed up, behind a
    :class:`CorrectionServer` (not started)."""
    device = resolve_device(args.device)
    if args.artifact:
        if Path(args.checkpoint).is_dir():  # a bundle, one artifact per z bucket
            corrector = ArtifactBundle.from_dir(args.checkpoint, device=device)
            corrector.warmup()
            warmup = None
        else:
            corrector = load_exported_corrector(args.checkpoint, device=device)
            warmup = corrector.volume_shape
    else:
        kwargs = dict(inference_patch_size=tuple(args.patch), overlap=args.overlap, batch_size=args.batch,
                      z_bucket=args.z_bucket, dtype=DTYPES[args.dtype], device=device)
        if args.reference_pt:
            corrector = CCTAContrastCorrector.from_reference_checkpoint(args.checkpoint, **kwargs)
        else:
            corrector = CCTAContrastCorrector.from_checkpoint(args.checkpoint, **kwargs)
        if args.dp_devices is not None:
            corrector.shard_over(local_devices(device, args.dp_devices))
            logging.getLogger(__name__).info("serving with the patch grid sharded over %d devices", args.dp_devices)
        warmup = tuple(args.warmup_shape) if args.warmup_shape else None
    return CorrectionServer(corrector, host=args.host, port=args.port, warmup_shape=warmup,
                            max_inflight=args.max_inflight)


def main(argv=None) -> None:
    """Serve until signalled (on the main thread) or until the server is
    shut down (embedded on another thread: ``start(background=False)``)."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    server = build_server(args)
    if threading.current_thread() is threading.main_thread():
        server.serve_until_signaled()
    else:
        server.start(background=False)


if __name__ == "__main__":
    main()
