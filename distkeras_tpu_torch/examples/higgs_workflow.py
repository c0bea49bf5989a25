"""ATLAS Higgs end-to-end workflow — full pipeline + trainer comparison, on
the port: the port of ``examples/higgs_workflow.py``.

Script form of the reference's ``examples/workflow.ipynb``: read the
tabular dataset, run the transformer pipeline, train the same model with
several distributed optimization algorithms (AEASGD, EAMSGD, ADAG,
DOWNPOUR, plus the SingleTrainer baseline), and report accuracy, AUC and
wall-clock for each — the reference notebook's algorithm-comparison table.

Run:  python -m distkeras_tpu_torch.examples.higgs_workflow
          [--workers N] [--rows 65536] [--device cuda]
"""

from __future__ import annotations

import argparse

from distkeras_tpu_torch import (ADAG, AEASGD, DOWNPOUR, EAMSGD,
                                 AccuracyEvaluator, AUCEvaluator,
                                 LabelIndexTransformer, ModelPredictor,
                                 OneHotTransformer, SingleTrainer,
                                 StandardScaleTransformer, higgs_mlp)
from distkeras_tpu_torch.data.datasets import load_atlas_higgs
from distkeras_tpu_torch.examples import default_workers


def evaluate(fitted, test, device):
    predicted = ModelPredictor(fitted, device=device).predict(test)
    # AUC from the class-probability column (the standard Higgs metric),
    # accuracy from the argmax index
    auc = AUCEvaluator().evaluate(predicted)
    predicted = LabelIndexTransformer().transform(predicted)
    return AccuracyEvaluator().evaluate(predicted), auc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--test-rows", type=int, default=8192)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train, test = load_atlas_higgs(n_train=args.rows, n_test=args.test_rows)
    for t in (StandardScaleTransformer(), OneHotTransformer(2)):
        train, test = t.transform(train), t.transform(test)

    workers = args.workers or default_workers(args.device)
    common = dict(batch_size=args.batch_size, num_epoch=args.epochs,
                  label_col="label_encoded", worker_optimizer="adam",
                  learning_rate=1e-3, device=args.device)
    dist = dict(common, num_workers=workers)

    def mlp():
        return higgs_mlp(device=args.device)

    trainers = [
        ("SingleTrainer", SingleTrainer(mlp(), **common)),
        ("ADAG", ADAG(mlp(), communication_window=12, **dist)),
        ("DOWNPOUR", DOWNPOUR(mlp(), communication_window=5, **dist)),
        ("AEASGD", AEASGD(mlp(), rho=5.0, communication_window=32,
                          **{k: v for k, v in dist.items()
                             if k != "learning_rate"})),
        ("EAMSGD", EAMSGD(mlp(), rho=5.0, momentum=0.9,
                          communication_window=32,
                          **{k: v for k, v in dist.items()
                             if k not in ("learning_rate",
                                          "worker_optimizer")})),
    ]

    print(f"{'algorithm':<14} {'accuracy':>9} {'auc':>7} {'time (s)':>9}")
    results = {}
    for name, trainer in trainers:
        fitted = trainer.train(train, shuffle=True)
        acc, auc = evaluate(fitted, test, args.device)
        results[name] = (acc, auc)
        print(f"{name:<14} {acc:>9.4f} {auc:>7.4f} "
              f"{trainer.get_training_time():>9.2f}")
    return results


if __name__ == "__main__":
    main()
