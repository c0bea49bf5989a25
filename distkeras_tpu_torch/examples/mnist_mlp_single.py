"""MNIST MLP with SingleTrainer — the baseline config, on the port.

Mirrors the reference's single-worker MNIST path (reference:
``examples/mnist.ipynb`` MLP variant + ``trainers.py :: SingleTrainer``):
load MNIST, MinMax-scale features, one-hot labels, train one model on one
device, evaluate accuracy.  The port of ``examples/mnist_mlp_single.py``.

Run:  python -m distkeras_tpu_torch.examples.mnist_mlp_single
          [--rows 8192] [--epochs 2] [--device cuda]
"""

from __future__ import annotations

import argparse

from distkeras_tpu_torch import (AccuracyEvaluator, LabelIndexTransformer,
                                 MinMaxTransformer, ModelPredictor,
                                 OneHotTransformer, SingleTrainer, mnist_mlp)
from distkeras_tpu_torch.data.datasets import load_mnist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--test-rows", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train, test = load_mnist(n_train=args.rows, n_test=args.test_rows)
    pipeline = [MinMaxTransformer(o_min=0.0, o_max=255.0),
                OneHotTransformer(10)]
    for t in pipeline:
        train, test = t.transform(train), t.transform(test)

    trainer = SingleTrainer(mnist_mlp(device=args.device),
                            batch_size=args.batch_size,
                            num_epoch=args.epochs, label_col="label_encoded",
                            worker_optimizer="adam", learning_rate=1e-3,
                            device=args.device)
    fitted = trainer.train(train, shuffle=True)
    print(f"training time: {trainer.get_training_time():.2f}s  "
          f"final loss: {trainer.get_history()[-1]:.4f}")

    predicted = ModelPredictor(fitted, device=args.device).predict(test)
    predicted = LabelIndexTransformer().transform(predicted)
    acc = AccuracyEvaluator().evaluate(predicted)
    print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
