"""MNIST ConvNet with ADAG — the flagship / north-star config, on the port.

Mirrors the reference's distributed MNIST ConvNet run (reference:
``examples/mnist.ipynb`` + ``trainers.py :: ADAG``; ``BASELINE.json``
north star).  The port of ``examples/mnist_convnet_adag.py``: the ADAG
window-delta exchange runs in the SPMD engine, one worker a CUDA device
by default (several workers on one device run in one process).

Run:  python -m distkeras_tpu_torch.examples.mnist_convnet_adag
          [--workers N] [--epochs 1] [--device cuda]
"""

from __future__ import annotations

import argparse

from distkeras_tpu_torch import (ADAG, AccuracyEvaluator,
                                 LabelIndexTransformer, MinMaxTransformer,
                                 ModelPredictor, OneHotTransformer,
                                 mnist_convnet)
from distkeras_tpu_torch.data.datasets import load_mnist
from distkeras_tpu_torch.examples import default_workers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--test-rows", type=int, default=2048)
    ap.add_argument("--workers", type=int, default=None,
                    help="default: one a CUDA device")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--window", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train, test = load_mnist(n_train=args.rows, n_test=args.test_rows)
    for t in (MinMaxTransformer(o_min=0.0, o_max=255.0),
              OneHotTransformer(10)):
        train, test = t.transform(train), t.transform(test)

    workers = args.workers or default_workers(args.device)
    trainer = ADAG(mnist_convnet(device=args.device), num_workers=workers,
                   batch_size=args.batch_size, num_epoch=args.epochs,
                   communication_window=args.window,
                   label_col="label_encoded", worker_optimizer="adam",
                   learning_rate=1e-3, device=args.device)
    fitted = trainer.train(train, shuffle=True)
    secs = trainer.get_training_time()
    examples = sum(e["examples"] for e in trainer.metrics)
    print(f"workers: {workers}  time: {secs:.2f}s  "
          f"throughput: {examples / secs:,.0f} examples/s "
          f"({examples / secs / workers:,.0f} /s/worker)")

    predicted = ModelPredictor(fitted, device=args.device).predict(test)
    predicted = LabelIndexTransformer().transform(predicted)
    acc = AccuracyEvaluator().evaluate(predicted)
    print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
