"""CIFAR-10 ConvNet with DOWNPOUR (the reference's DOWNPOUR config,
``BASELINE.json.configs``), on the port: the port of
``examples/cifar10_downpour.py``.

Run:  python -m distkeras_tpu_torch.examples.cifar10_downpour
          [--workers N] [--execution spmd|host_ps|process_ps]
          [--device cuda]
"""

from __future__ import annotations

import argparse

from distkeras_tpu_torch import (DOWNPOUR, AccuracyEvaluator,
                                 LabelIndexTransformer, MinMaxTransformer,
                                 ModelPredictor, OneHotTransformer,
                                 cifar10_convnet)
from distkeras_tpu_torch.data.datasets import load_cifar10
from distkeras_tpu_torch.examples import default_workers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--test-rows", type=int, default=2048)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--execution", default="spmd",
                    choices=["spmd", "host_ps", "process_ps"])
    ap.add_argument("--wire", default=None,
                    choices=["bfloat16", "int8", "topk"],
                    help="commit compression on the PS engines "
                         "(requires --execution host_ps/process_ps)")
    ap.add_argument("--wire-topk", type=float, default=0.01,
                    help="top-k density for --wire topk")
    ap.add_argument("--elastic", action="store_true",
                    help="lease-based elastic workers: worker deaths/"
                         "stragglers lose zero examples (requires "
                         "--execution host_ps)")
    ap.add_argument("--chaos-kill", type=int, default=None, metavar="N",
                    help="with --elastic: inject worker 0 exiting at its "
                         "N-th commit (death/respawn demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train, test = load_cifar10(n_train=args.rows, n_test=args.test_rows)
    for t in (MinMaxTransformer(o_min=0.0, o_max=255.0),
              OneHotTransformer(10)):
        train, test = t.transform(train), t.transform(test)

    workers = args.workers or default_workers(args.device)
    faults = ({0: ("exit", args.chaos_kill)}
              if args.elastic and args.chaos_kill else None)
    trainer = DOWNPOUR(cifar10_convnet(device=args.device),
                       num_workers=workers, batch_size=args.batch_size,
                       num_epoch=args.epochs,
                       communication_window=args.window,
                       label_col="label_encoded", worker_optimizer="adam",
                       learning_rate=5e-4, execution=args.execution,
                       wire_dtype=args.wire, wire_topk=args.wire_topk,
                       elastic=args.elastic, fault_injection=faults,
                       device=args.device)
    fitted = trainer.train(train, shuffle=True)
    print(f"time: {trainer.get_training_time():.2f}s  "
          f"final loss: {trainer.get_history()[-1]:.4f}")
    if args.elastic:
        s = trainer.elastic_stats
        print(f"elastic: respawns={s['respawns']} "
              f"leases_reassigned={s['leases_reassigned']} "
              f"windows_per_worker={s['windows_per_worker']}")

    predicted = ModelPredictor(fitted, device=args.device).predict(test)
    predicted = LabelIndexTransformer().transform(predicted)
    acc = AccuracyEvaluator().evaluate(predicted)
    print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
