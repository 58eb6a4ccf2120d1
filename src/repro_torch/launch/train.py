"""Training launcher of the port (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 4 --batch 4 --seq 256 --mesh-data 2

Flag names are the reference's; ``--mesh-data`` is the in-process EF world
W. The defaults select the path the port runs (``--strategy ef_allgather``,
``--optimizer sgd``). It runs on the card; ``--device cpu`` (with
``--reduced``) runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.comm.bucketize import DEFAULT_BUCKET_SIZE
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.train.loop import TrainJob, run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--optimizer", default="sgd", help="local chain (the port has sgd)")
    ap.add_argument("--strategy", default="ef_allgather")
    ap.add_argument("--compressor", default="scaled_sign", help="scaled_sign | sign")
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--mesh-data", type=int, default=1, help="in-process EF world W")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--bucket-size", type=int, default=DEFAULT_BUCKET_SIZE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default cuda; cpu only when asked")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    job = TrainJob(
        cfg=cfg, world=args.mesh_data, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        optimizer=args.optimizer, strategy=args.strategy, compressor=args.compressor,
        seed=args.seed, bucket_size=args.bucket_size,
    )
    _, history = run_training(
        job, log_fn=lambda r: print(json.dumps(r), flush=True), device=args.device
    )
    final = history[-1]["loss"] if history else float("nan")
    print(f"final_loss={final:.4f}")


if __name__ == "__main__":
    main()
