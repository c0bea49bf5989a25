"""Keras → port model conversion, a copy of
``distkeras_tpu/core/keras_adapter.py`` kept in the port so that it
imports nothing of the JAX package.

Two changes from the JAX module:

 - **no Keras import**: the adapter takes the ``keras`` module from
   ``sys.modules`` (a caller that holds a Keras model has imported it
   already) and raises ``TypeError`` when it is absent.  Keras pulls in
   jax (and its default backend) when imported, so the port never
   triggers that import;
 - ``convert_keras_model(km, device=)`` builds the port's ``Sequential``
   on a torch device (``None`` means the CUDA card; tests pass ``"cpu"``),
   with parameters drawn by the port's own initializers.  The Keras
   weights come from :func:`keras_weights` as the flat list in JAX leaf
   order, so ``load_jax_weights`` (or ``set_weights``) carries them
   across.

The JAX module's description follows.

Keras → native model conversion.

The reference's public API takes an actual ``keras.Model``
(reference: ``distkeras/trainers.py :: Trainer.__init__(keras_model=...)``;
its own MNIST-ConvNet examples build FUNCTIONAL models, not just
Sequential).  For drop-in familiarity our trainers accept one too: this
adapter converts a Keras ``Sequential`` OR a single-input single-output
linear-chain ``Functional`` model of supported layer types into the native
declarative ``Sequential`` (whose forward pass is a pure jittable
function), and extracts the Keras weights **re-ordered into the native
pytree leaf order** so a converted model starts from identical parameters.
Branching graphs (skip connections, merges, shared layers) are rejected
loudly — converting them to a chain would silently change the function.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..device import DeviceLike
from .model import Sequential
from . import layers as L


def _require_keras():
    """The ``keras`` module the caller imported; never imported here."""
    keras = sys.modules.get("keras")
    if keras is None:
        raise TypeError(
            "Converting a Keras model needs the `keras` module the model "
            "came from, and none is imported; build the model with "
            "distkeras_tpu_torch.core layers instead (same constructor "
            "surface: Dense/Conv2D/MaxPooling2D/...)")
    return keras


def _act_name(activation) -> str:
    name = getattr(activation, "__name__", None) or str(activation)
    return {"linear": None}.get(name, name)


def _convert_layer(kl) -> List[L.Layer]:
    """One Keras layer → zero or more native layers."""
    t = type(kl).__name__
    cfg = kl.get_config()
    if t == "Dense":
        return [L.Dense(cfg["units"], activation=_act_name(kl.activation),
                        use_bias=cfg.get("use_bias", True))]
    if t == "Conv2D":
        if cfg.get("data_format") == "channels_first":
            raise ValueError("channels_first Conv2D not supported (the "
                             "layout is NHWC)")
        dil = tuple(np.broadcast_to(cfg.get("dilation_rate", 1), (2,)))
        if dil != (1, 1) or cfg.get("groups", 1) != 1:
            raise ValueError(
                f"Conv2D with dilation_rate={dil} / groups="
                f"{cfg.get('groups', 1)} is not supported by the converter; "
                "converting would silently change the computed function")
        return [L.Conv2D(cfg["filters"], cfg["kernel_size"],
                         strides=cfg.get("strides", 1),
                         padding=cfg.get("padding", "valid"),
                         activation=_act_name(kl.activation),
                         use_bias=cfg.get("use_bias", True))]
    if t == "MaxPooling2D":
        return [L.MaxPooling2D(cfg["pool_size"], cfg.get("strides"),
                               cfg.get("padding", "valid"))]
    if t == "AveragePooling2D":
        return [L.AveragePooling2D(cfg["pool_size"], cfg.get("strides"),
                                   cfg.get("padding", "valid"))]
    if t == "GlobalAveragePooling2D":
        return [L.GlobalAveragePooling2D()]
    if t == "Flatten":
        return [L.Flatten()]
    if t == "Reshape":
        return [L.Reshape(cfg["target_shape"])]
    if t == "Activation":
        return [L.Activation(_act_name(kl.activation))]
    if t == "Dropout":
        return [L.Dropout(cfg["rate"])]
    if t == "BatchNormalization":
        axis = cfg.get("axis", -1)
        axis = axis[0] if isinstance(axis, (list, tuple)) else axis
        if axis not in (-1, 3) or not cfg.get("center", True) \
                or not cfg.get("scale", True):
            raise ValueError(
                "BatchNormalization with axis != last or center/scale=False "
                "is not supported by the converter")
        return [L.BatchNormalization(cfg.get("momentum", 0.99),
                                     cfg.get("epsilon", 1e-3))]
    if t == "Embedding":
        return [L.Embedding(cfg["input_dim"], cfg["output_dim"])]
    if t == "LayerNormalization":
        axis = cfg.get("axis", -1)
        axis = axis[0] if isinstance(axis, (list, tuple)) else axis
        if axis != -1 or not cfg.get("center", True) \
                or not cfg.get("scale", True):
            raise ValueError(
                "LayerNormalization with axis != -1 or center/scale=False "
                "is not supported by the converter")
        return [L.LayerNormalization(cfg.get("epsilon", 1e-3))]
    if t == "InputLayer":
        return []
    raise ValueError(f"Unsupported Keras layer type {t!r}")


def _ordered_layers(km) -> List:
    """Layers in forward (data-flow) order.

    Keras ``Sequential``: ``km.layers`` as listed.  Functional
    ``keras.Model``: the unique input→output chain, recovered from the
    inbound-node graph; anything non-linear — multiple inputs/outputs, a
    layer called twice, a merge (Add/Concatenate), a branch — is rejected
    with a specific message rather than silently mis-converted.
    """
    keras = _require_keras()
    if isinstance(km, keras.Sequential):
        return list(km.layers)
    if not isinstance(km, keras.Model):
        raise TypeError(f"expected a keras.Model, got {type(km)!r}")
    inputs = getattr(km, "inputs", None) or []
    outputs = getattr(km, "outputs", None) or []
    if len(inputs) != 1 or len(outputs) != 1:
        raise ValueError(
            f"only single-input single-output Keras models convert "
            f"(got {len(inputs)} inputs, {len(outputs)} outputs)")
    parents = {}
    for kl in km.layers:
        nodes = getattr(kl, "_inbound_nodes", [])
        if len(nodes) != 1:
            raise ValueError(
                f"Keras layer {kl.name!r} is called {len(nodes)} times — "
                "shared layers are not linear-chain convertible")
        ps = [t._keras_history[0].name for t in nodes[0].input_tensors]
        if len(ps) > 1:
            raise ValueError(
                f"Keras layer {kl.name!r} merges {len(ps)} inputs — "
                "skip connections/merges are not linear-chain convertible")
        parents[kl.name] = ps
    child = {}
    for name, ps in parents.items():
        for p in ps:
            if p in child:
                raise ValueError(
                    f"Keras layer {p!r} feeds both {child[p]!r} and "
                    f"{name!r} — branching graphs are not linear-chain "
                    "convertible")
            child[p] = name
    by_name = {kl.name: kl for kl in km.layers}
    roots = [kl for kl in km.layers if not parents[kl.name]]
    if len(roots) != 1:
        raise ValueError(f"expected one root (InputLayer), found "
                         f"{[r.name for r in roots]}")
    chain = [roots[0]]
    while chain[-1].name in child:
        chain.append(by_name[child[chain[-1].name]])
    if len(chain) != len(km.layers):
        missing = sorted(set(by_name) - {kl.name for kl in chain})
        raise ValueError(f"layers {missing} are not on the input→output "
                         "chain — not a linear model")
    out_name = outputs[0]._keras_history[0].name
    if chain[-1].name != out_name:
        raise ValueError(f"chain ends at {chain[-1].name!r} but the model "
                         f"output comes from {out_name!r}")
    return chain


def convert_keras_model(km, device: DeviceLike = None) -> Sequential:
    """Convert a Keras Sequential or linear-chain functional model to the
    port's ``Sequential`` on ``device``, with freshly drawn parameters
    (the Keras weights come from :func:`keras_weights`)."""
    chain = _ordered_layers(km)  # a TypeError for anything not Keras
    in_shape = getattr(km, "input_shape", None)
    if in_shape is None:
        raise ValueError("Keras model must be built (call it once or pass "
                         "input_shape) before conversion")
    native_layers: List[L.Layer] = []
    for kl in chain:
        native_layers.extend(_convert_layer(kl))
    return Sequential(native_layers, input_shape=tuple(in_shape[1:]),
                      name=getattr(km, "name", "converted"), device=device)


def keras_weights(km) -> List[np.ndarray]:
    """Keras weights re-ordered to the native pytree leaf order.

    Native leaves per layer are dict keys in sorted order
    (Dense: bias, kernel; BatchNorm: offset, scale, stats.mean, stats.var),
    while Keras ``get_weights`` returns [kernel, bias] / [gamma, beta,
    moving_mean, moving_var].  Iterates the same forward order as
    ``convert_keras_model`` (chain order for functional models).
    """
    _require_keras()
    out: List[np.ndarray] = []
    for kl in _ordered_layers(km):
        t = type(kl).__name__
        w = [np.asarray(a) for a in kl.get_weights()]
        if t in ("Dense", "Conv2D"):
            if len(w) == 2:       # [kernel, bias] → bias, kernel
                out.extend([w[1], w[0]])
            else:                 # no bias → kernel only
                out.extend(w)
        elif t == "BatchNormalization":
            if len(w) != 4:
                raise ValueError(
                    f"BatchNormalization layer {kl.name!r} has {len(w)} "
                    "weight arrays (expected 4: gamma, beta, moving_mean, "
                    "moving_var) — center=False/scale=False are unsupported")
            gamma, beta, mean, var = w
            out.extend([beta, gamma, mean, var])
        elif t == "Embedding":
            out.extend(w)
        elif t == "LayerNormalization":
            if len(w) != 2:
                raise ValueError(
                    f"LayerNormalization layer {kl.name!r} has {len(w)} "
                    "weight arrays (expected 2: gamma, beta)")
            gamma, beta = w
            out.extend([beta, gamma])  # native sorted order: offset, scale
        elif w:
            raise ValueError(f"Unexpected weights on Keras layer {t!r}")
    return out
