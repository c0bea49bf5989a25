"""Layers of the port, counterparts of ``distkeras_tpu/core/layers.py``.

Each layer is an ``nn.Module`` that holds its parameters.  It is created
from its configuration alone (the same constructor arguments as the JAX
spec) and gets its parameters from :meth:`Layer.build`, which takes the
input shape (batch dim excluded), an explicit ``torch.Generator`` and the
device — the counterpart of the JAX ``init(rng, in_shape)``.

Interchange with the JAX package is exact:

- ``get_config`` writes the instance attributes set by the constructor, so
  fields left at their class defaults (``num_kv_heads``, ``rope``, ...) are
  absent from the JSON, as in the JAX package; ``from_config`` bypasses
  the constructor and the class defaults fill them back in.
- Parameters keep the JAX names and layouts (Dense kernels are (in, out),
  Conv2D kernels HWIO), and :func:`layer_leaves` walks them in JAX pytree
  leaf order (dict keys sorted), which is the order of ``get_weights``.
  BatchNormalization's running statistics are buffers of a ``stats``
  sub-module, so they come out as ``stats/mean`` and ``stats/var``
  after ``offset`` and ``scale``, as in the JAX params dict.
- Images are NHWC, as in the JAX package.  A convolution hands cuDNN the
  NHWC activations as an NCHW view in ``channels_last`` memory format, so
  no layout copy is made.
- Matmuls take operands rounded to the compute dtype and produce f32
  (``preferred_element_type=f32`` in the JAX package), and so does a
  convolution's forward, whose backward runs in the compute dtype (the
  JAX ``_conv_f32_acc`` contract); LayerNorm and BatchNorm are f32;
  residual adds stay in the activation dtype.  Parameters are f32, and
  gradients flow back through those casts into them, as ``jax.grad``
  does through ``astype``.
- ``forward(x, compute_dtype, train=False, generator=None)`` is the JAX
  ``apply(params, x, compute_dtype=, train=, rng=)``: ``train`` turns on
  dropout, whose masks are drawn from ``generator`` (a ``torch.Generator``
  on the input's device; JAX's threefry bits and torch's differ, so the
  masks are not the JAX package's).

Every layer of the JAX module is ported: Dense, Conv2D, MaxPooling2D,
AveragePooling2D, GlobalAveragePooling2D, Flatten, Reshape, Activation,
Dropout, BatchNormalization, LayerNormalization, PositionalEmbedding,
MultiHeadAttention, TransformerBlock and Embedding.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
}


def get_activation(name: Optional[str]):
    if name is None:
        return _ACTIVATIONS["linear"]
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None


def _apply_activation(name, x):
    # softmax-family runs in f32 for numerical stability under bf16 compute
    if name in ("softmax", "log_softmax", "sigmoid"):
        return get_activation(name)(x.to(torch.float32))
    return get_activation(name)(x)


# ---------------------------------------------------------------------------
# initializers (Keras-compatible names, as in the JAX package)
# ---------------------------------------------------------------------------

def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def init_weight(generator: torch.Generator, shape: Sequence[int],
                scheme: str = "glorot_uniform") -> torch.Tensor:
    """An f32 CPU tensor drawn from ``generator`` (a CPU generator)."""
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)
    if scheme in ("glorot_uniform", "he_uniform"):
        limit = math.sqrt(6.0 / (fan_in + fan_out if scheme ==
                                 "glorot_uniform" else fan_in))
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit
    if scheme in ("glorot_normal", "he_normal"):
        std = math.sqrt(2.0 / (fan_in + fan_out if scheme == "glorot_normal"
                               else fan_in))
        return std * torch.randn(shape, generator=generator)
    if scheme == "zeros":
        return torch.zeros(shape)
    if scheme == "ones":
        return torch.ones(shape)
    raise ValueError(f"Unknown initializer {scheme!r}")


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(device=device, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Layer base
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """Base layer.  Subclasses implement ``build(in_shape, generator,
    device) -> out_shape`` (creates the parameters) and
    ``forward(x, compute_dtype, train=False, generator=None)``."""

    #: class-level registry name (set via __init_subclass__)
    kind: str = "Layer"

    _REGISTRY: Dict[str, type] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.kind = cls.__name__
        if not cls.__name__.startswith("_"):  # a shared base is no kind
            Layer._REGISTRY[cls.__name__] = cls

    # -- config (serialization) --------------------------------------------
    def get_config(self) -> Dict[str, Any]:
        # nn.Module keeps its own state under underscore names, plus
        # ``training``; everything else in __dict__ is configuration
        cfg = {k: v for k, v in self.__dict__.items()
               if not k.startswith("_") and k != "training"}
        cfg["kind"] = self.kind
        return cfg

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "Layer":
        cfg = dict(cfg)
        kind = cfg.pop("kind")
        try:
            cls = Layer._REGISTRY[kind]
        except KeyError:
            raise ValueError(f"layer kind {kind!r} is not ported yet; "
                             f"ported: {sorted(Layer._REGISTRY)}") from None
        obj = cls.__new__(cls)
        nn.Module.__init__(obj)
        # JSON turns tuples into lists; shape fields come back as tuples
        for k, v in cfg.items():
            setattr(obj, k, tuple(v) if isinstance(v, list) else v)
        return obj

    def build(self, in_shape: Tuple[int, ...], generator: torch.Generator,
              device) -> Tuple[int, ...]:  # pragma: no cover - abstract
        raise NotImplementedError

    def extra_repr(self) -> str:
        cfg = {k: v for k, v in self.get_config().items() if k != "kind"}
        return ", ".join(f"{k}={v!r}" for k, v in cfg.items())


def layer_leaves(module: nn.Module, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs in JAX pytree leaf order: a layer's
    parameters, buffers (BatchNorm's running statistics) and sub-layers
    form one dict whose keys are sorted."""
    entries = {**module._parameters, **module._buffers, **module._modules}
    for name in sorted(entries):
        value = entries[name]
        if value is None:
            continue
        if isinstance(value, nn.Module):
            yield from layer_leaves(value, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", value


# ---------------------------------------------------------------------------
# Core layers
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor], compute_dtype) -> torch.Tensor:
    """x @ kernel with operands rounded to ``compute_dtype`` and an f32
    result.  A product of two bf16 values is exact in f32, so upcasting the
    rounded operands reproduces ``preferred_element_type=f32``; a bf16
    ``torch.matmul`` would round its output to bf16 before the bias add."""
    y = torch.matmul(x.to(compute_dtype).to(torch.float32),
                     kernel.to(compute_dtype).to(torch.float32))
    if bias is not None:
        y = y + bias
    return y


class Dense(Layer):
    """Fully connected layer; the kernel is stored (in, out)."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, kernel_init: str = "glorot_uniform"):
        super().__init__()
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_init = kernel_init

    def build(self, in_shape, generator, device):
        d = in_shape[-1]
        self.kernel = _param(init_weight(generator, (d, self.units),
                                         self.kernel_init), device)
        if self.use_bias:
            self.bias = _param(torch.zeros(self.units), device)
        return tuple(in_shape[:-1]) + (self.units,)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        y = _project(x, self.kernel, self.bias if self.use_bias else None,
                     compute_dtype)
        return _apply_activation(self.activation, y)


class LayerNormalization(Layer):
    """Layer norm over the trailing dim: f32 arithmetic, biased variance,
    result cast back to the input dtype."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = float(epsilon)

    def build(self, in_shape, generator, device):
        c = in_shape[-1]
        self.scale = _param(torch.ones(c), device)
        self.offset = _param(torch.zeros(c), device)
        return tuple(in_shape)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.offset).to(x.dtype)


class PositionalEmbedding(Layer):
    """Learned additive positional embedding for (B, S, D) inputs."""

    def __init__(self, max_len: int):
        super().__init__()
        self.max_len = int(max_len)

    def build(self, in_shape, generator, device):
        s, d = in_shape
        if s > self.max_len:
            raise ValueError(f"sequence {s} exceeds max_len {self.max_len}")
        self.embedding = _param(
            0.02 * torch.randn((self.max_len, d), generator=generator),
            device)
        return tuple(in_shape)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        s = x.shape[1]
        return x + self.embedding[:s].to(x.dtype)


class MultiHeadAttention(Layer):
    """Multi-head self-attention on (B, S, D) inputs, through
    ``ops.attention.attention`` (the flash kernel on the card, the plain
    path elsewhere).  ``num_kv_heads`` < ``num_heads`` is grouped-query
    attention."""

    #: class-level defaults, so configs that lack these fields (the JSON
    #: omits fields left at their defaults) deserialize as classic MHA
    num_kv_heads: Optional[int] = None
    attention_window: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    rope_scale: float = 1.0

    def __init__(self, num_heads: int, key_dim: int, causal: bool = False,
                 use_bias: bool = True, attention_impl: Optional[str] = None,
                 num_kv_heads: Optional[int] = None,
                 attention_window: Optional[int] = None,
                 rope: bool = False, rope_theta: float = 10000.0,
                 rope_scale: float = 1.0):
        super().__init__()
        self.num_heads = int(num_heads)
        self.key_dim = int(key_dim)  # per-head dim
        self.causal = bool(causal)
        self.use_bias = bool(use_bias)
        self.attention_impl = attention_impl
        if num_kv_heads is not None:
            self.num_kv_heads = int(num_kv_heads)
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"num_heads={self.num_heads} not divisible by "
                    f"num_kv_heads={self.num_kv_heads}")
        _set_window_and_rope(self, causal, attention_window, rope,
                             rope_theta, rope_scale)

    def _kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)

    def build(self, in_shape, generator, device):
        s, d = in_shape
        inner = self.num_heads * self.key_dim
        inner_kv = self._kv_heads() * self.key_dim
        for name, shape in (("wq", (d, inner)), ("wk", (d, inner_kv)),
                            ("wv", (d, inner_kv)), ("wo", (inner, d))):
            setattr(self, name, _param(init_weight(generator, shape),
                                       device))
        if self.use_bias:
            for name, n in (("bq", inner), ("bk", inner_kv),
                            ("bv", inner_kv), ("bo", d)):
                setattr(self, name, _param(torch.zeros(n), device))
        return tuple(in_shape)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        from ..ops.attention import attention
        b, s, _ = x.shape
        dh = self.key_dim

        def proj(name, heads):
            bias = getattr(self, "b" + name[1]) if self.use_bias else None
            y = _project(x, getattr(self, name), bias, compute_dtype)
            return y.to(compute_dtype).reshape(b, s, heads, dh)

        q = proj("wq", self.num_heads)
        k = proj("wk", self._kv_heads())
        v = proj("wv", self._kv_heads())
        if self.rope:
            from ..ops.rope import apply_rope
            pos = torch.arange(s, device=x.device)
            q = apply_rope(q, pos, self.rope_theta, self.rope_scale)
            k = apply_rope(k, pos, self.rope_theta, self.rope_scale)
        out = attention(q, k, v, causal=self.causal,
                        impl=self.attention_impl,
                        window=self.attention_window)
        out = out.reshape(b, s, self.num_heads * dh)
        return _project(out, self.wo, self.bo if self.use_bias else None,
                        compute_dtype)


def _set_window_and_rope(layer, causal, attention_window, rope, rope_theta,
                         rope_scale):
    """The attention_window / rope fields of MultiHeadAttention and
    TransformerBlock: set only when they differ from the class default, so
    the JSON matches the JAX package's."""
    if attention_window is not None:
        from ..ops.attention import validate_window
        layer.attention_window = validate_window(attention_window, causal)
    if rope:
        from ..ops.rope import validate_rope_dim
        validate_rope_dim(layer.key_dim)
        layer.rope = True
    if rope_theta != 10000.0 or rope_scale != 1.0:
        if not rope:
            raise ValueError(
                f"rope_theta={rope_theta}/rope_scale={rope_scale} set but "
                "rope=False — pass rope=True to enable rotary embeddings, "
                "or drop the knobs")
        from ..ops.rope import validate_rope_scaling
        layer.rope_theta, layer.rope_scale = validate_rope_scaling(
            rope_theta, rope_scale)


class TransformerBlock(Layer):
    """Pre-LN transformer block: LN → MHA → residual, LN → MLP → residual.

    Its parameters are ``attn`` (a MultiHeadAttention), ``ln1`` and ``ln2``
    (LayerNormalizations) and ``mlp_w1``/``mlp_b1``/``mlp_w2``/``mlp_b2``,
    the JAX package's param dict; the sub-layers are built from this
    block's configuration and are not part of it."""

    #: class-level defaults mirror MultiHeadAttention (older configs)
    num_kv_heads: Optional[int] = None
    attention_window: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    rope_scale: float = 1.0

    def __init__(self, num_heads: int, key_dim: int, mlp_dim: int,
                 dropout: float = 0.0, causal: bool = False,
                 activation: str = "gelu",
                 attention_impl: Optional[str] = None,
                 num_kv_heads: Optional[int] = None,
                 attention_window: Optional[int] = None,
                 rope: bool = False, rope_theta: float = 10000.0,
                 rope_scale: float = 1.0):
        super().__init__()
        self.num_heads = int(num_heads)
        self.key_dim = int(key_dim)
        self.mlp_dim = int(mlp_dim)
        self.dropout = float(dropout)
        self.causal = bool(causal)
        self.activation = activation
        self.attention_impl = attention_impl
        if num_kv_heads is not None:
            self.num_kv_heads = int(num_kv_heads)
        _set_window_and_rope(self, causal, attention_window, rope,
                             rope_theta, rope_scale)

    def _mha(self) -> MultiHeadAttention:
        return MultiHeadAttention(self.num_heads, self.key_dim,
                                  causal=self.causal,
                                  attention_impl=self.attention_impl,
                                  num_kv_heads=self.num_kv_heads,
                                  attention_window=self.attention_window,
                                  rope=self.rope,
                                  rope_theta=self.rope_theta,
                                  rope_scale=self.rope_scale)

    def build(self, in_shape, generator, device):
        s, d = in_shape
        # the JAX init draws ln1, attn, ln2, w1, w2 in this order
        self.ln1 = LayerNormalization()
        self.ln1.build(in_shape, generator, device)
        self.attn = self._mha()
        self.attn.build(in_shape, generator, device)
        self.ln2 = LayerNormalization()
        self.ln2.build(in_shape, generator, device)
        self.mlp_w1 = _param(init_weight(generator, (d, self.mlp_dim)),
                             device)
        self.mlp_b1 = _param(torch.zeros(self.mlp_dim), device)
        self.mlp_w2 = _param(init_weight(generator, (self.mlp_dim, d)),
                             device)
        self.mlp_b2 = _param(torch.zeros(d), device)
        return tuple(in_shape)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        h = self.ln1(x, compute_dtype)
        h = self.attn(h, compute_dtype)
        x = x + _dropout(generator, self.dropout, h.to(x.dtype), train)
        h = self.ln2(x, compute_dtype)
        h = _project(h, self.mlp_w1, self.mlp_b1, compute_dtype)
        h = _apply_activation(self.activation, h).to(compute_dtype)
        h = _project(h, self.mlp_w2, self.mlp_b2, compute_dtype)
        return x + _dropout(generator, self.dropout, h.to(x.dtype), train)


class Embedding(Layer):
    """Token embedding: gathers rows of the table cast to compute dtype."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)

    def build(self, in_shape, generator, device):
        self.embedding = _param(
            0.02 * torch.randn((self.input_dim, self.output_dim),
                               generator=generator), device)
        return tuple(in_shape) + (self.output_dim,)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return F.embedding(x.long(), self.embedding.to(compute_dtype))


def _dropout(generator: Optional[torch.Generator], rate: float,
             x: torch.Tensor, train: bool) -> torch.Tensor:
    """Inverted dropout; identity at inference (shared by Dropout and
    TransformerBlock so the semantics live in one place).  Keeps each
    element with probability 1 - rate, drawn from ``generator``, and
    scales the kept ones by 1 / (1 - rate)."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("Dropout in train mode requires a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(Layer):
    """Inverted dropout; identity at inference.  Uses the generator
    threaded through ``Sequential.forward`` (no global RNG state)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def build(self, in_shape, generator, device):
        return tuple(in_shape)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return _dropout(generator, self.rate, x, train)


# ---------------------------------------------------------------------------
# Convolution, pooling, reshaping and batch norm (the ConvNet/MLP zoo)
# ---------------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    """An int or a pair → a pair of ints (``np.broadcast_to(v, (2,))``)."""
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected one int or two, got {v!r}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _window_pads(in_hw, window, strides, padding: str
                 ) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding of XLA's ``padding`` for a
    window: none for ``"VALID"``; for ``"SAME"`` enough for ceil(n / s)
    outputs, split with the odd row or column at the end."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    pads = []
    for n, k, s in zip(in_hw, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def _window_out(in_hw, window, strides, padding: str) -> Tuple[int, int]:
    """Output height and width of a window op (XLA's shape rule)."""
    if padding == "SAME":
        return tuple(-(-n // s) for n, s in zip(in_hw, strides))
    out = tuple((n - k) // s + 1 for n, k, s in zip(in_hw, window, strides))
    if min(out) < 1:
        raise ValueError(f"window {window} does not fit the input {in_hw} "
                         "with VALID padding")
    return out


def _nchw(x: torch.Tensor, pads, fill: float) -> torch.Tensor:
    """An NHWC tensor as the NCHW view (``channels_last`` memory for an
    NHWC-contiguous input), padded by ``pads`` with ``fill``."""
    x = x.permute(0, 3, 1, 2)
    t, b, l, r = pads
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=fill)
    return x


@contextlib.contextmanager
def _cudnn_tf32(operand_dtype: torch.dtype):
    """cuDNN's TF32 switch for convolutions of ``operand_dtype``-rounded
    operands, whatever the process-wide setting: on for bf16 and f16
    operands (their 8- and 11-bit significands are exact in TF32, so the
    products are exact and the sums f32: the same function, on the tensor
    cores), off for f32 operands (TF32 would round them)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = operand_dtype != torch.float32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _ConvF32Acc(torch.autograd.Function):
    """Port of ``_conv_f32_acc``: a convolution of NHWC ``x`` and HWIO
    ``k``, both already rounded to the compute dtype, whose forward output
    is f32, and whose backward runs entirely in the compute dtype.

    The forward upcasts the rounded operands and convolves in f32, as
    ``_project`` does for Dense: a product of two bf16 values is exact in
    f32, so this is the JAX ``preferred_element_type=f32`` result.  The
    backward rounds the cotangent once to the compute dtype and takes the
    input and kernel gradients from same-dtype convolutions, the JAX
    custom VJP's documented contract (less precise than Dense's
    gradients).  Symmetric padding goes to the convolution itself; XLA's
    asymmetric SAME padding (stride > 1 or an even kernel) is an explicit
    zero pad, whose rows and columns the input gradient then drops.  On
    the card the f32 forward of 16-bit operands runs on TF32 tensor cores
    and an f32 model's convolutions never do (:func:`_cudnn_tf32`)."""

    @staticmethod
    def forward(ctx, x, k, strides, pads):
        t, b, l, r = pads
        symmetric = t == b and l == r
        conv_pad = (t, l) if symmetric else (0, 0)
        xp = _nchw(x, (0, 0, 0, 0) if symmetric else pads, 0.0)
        w = k.permute(3, 2, 0, 1)  # HWIO -> OIHW
        with _cudnn_tf32(x.dtype):
            y = F.conv2d(xp.to(torch.float32), w.to(torch.float32),
                         stride=strides, padding=conv_pad)
        ctx.save_for_backward(x, k)
        ctx.conf = (strides, pads, symmetric, conv_pad)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        strides, pads, symmetric, conv_pad = ctx.conf
        g = g.to(x.dtype).permute(0, 3, 1, 2)
        xp = _nchw(x, (0, 0, 0, 0) if symmetric else pads, 0.0)
        w = k.permute(3, 2, 0, 1)
        dx = dk = None
        with _cudnn_tf32(x.dtype):
            if ctx.needs_input_grad[0]:
                dxp = torch.nn.grad.conv2d_input(xp.shape, w, g,
                                                 stride=strides,
                                                 padding=conv_pad)
                t, _, l, _ = (0, 0, 0, 0) if symmetric else pads
                dx = dxp[:, :, t:t + x.shape[1], l:l + x.shape[2]]
                dx = dx.permute(0, 2, 3, 1)
            if ctx.needs_input_grad[1]:
                dk = torch.nn.grad.conv2d_weight(xp, w.shape, g,
                                                 stride=strides,
                                                 padding=conv_pad)
                dk = dk.permute(2, 3, 1, 0)  # OIHW -> HWIO
        return dx, dk, None, None


class Conv2D(Layer):
    """2-D convolution on NHWC inputs; the kernel is stored HWIO."""

    def __init__(self, filters: int, kernel_size=3, strides=1,
                 padding: str = "SAME", activation: Optional[str] = None,
                 use_bias: bool = True, kernel_init: str = "he_normal"):
        super().__init__()
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding.upper()
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_init = kernel_init

    def build(self, in_shape, generator, device):
        h, w, cin = in_shape
        kh, kw = self.kernel_size
        self.kernel = _param(init_weight(generator, (kh, kw, cin,
                                                     self.filters),
                                         self.kernel_init), device)
        if self.use_bias:
            self.bias = _param(torch.zeros(self.filters), device)
        return _window_out((h, w), self.kernel_size, self.strides,
                           self.padding) + (self.filters,)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        pads = _window_pads(x.shape[1:3], self.kernel_size, self.strides,
                            self.padding)
        y = _ConvF32Acc.apply(x.to(compute_dtype),
                              self.kernel.to(compute_dtype), self.strides,
                              pads)
        if self.use_bias:
            y = y + self.bias
        return _apply_activation(self.activation, y)


class _Pooling2D(Layer):
    """The window configuration shared by the two pooling layers."""

    def __init__(self, pool_size=2, strides=None, padding: str = "VALID"):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.strides = (_pair(strides) if strides is not None
                        else self.pool_size)
        self.padding = padding.upper()

    def build(self, in_shape, generator, device):
        h, w, c = in_shape
        return _window_out((h, w), self.pool_size, self.strides,
                           self.padding) + (c,)

    def _pads(self, x):
        return _window_pads(x.shape[1:3], self.pool_size, self.strides,
                            self.padding)


class MaxPooling2D(_Pooling2D):
    """Max over each window; SAME pads with -inf (the JAX
    ``reduce_window`` init value)."""

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        fill = (float("-inf") if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        y = F.max_pool2d(_nchw(x, self._pads(x), fill), self.pool_size,
                         self.strides)
        return y.permute(0, 2, 3, 1)


class AveragePooling2D(_Pooling2D):
    """The sum over each zero-padded window divided by the full pool size,
    as the JAX layer does (``count_include_pad`` with XLA's asymmetric
    SAME padding, hence the explicit pad)."""

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        y = F.avg_pool2d(_nchw(x, self._pads(x), 0.0), self.pool_size,
                         self.strides)
        return y.permute(0, 2, 3, 1)


class GlobalAveragePooling2D(Layer):
    """Mean over height and width: (B, H, W, C) → (B, C)."""

    def build(self, in_shape, generator, device):
        return (in_shape[-1],)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return x.mean(dim=(1, 2))


class Flatten(Layer):
    """(B, ...) → (B, prod(...)) in the activations' logical NHWC order,
    so the Dense after it reads the JAX package's feature order."""

    def build(self, in_shape, generator, device):
        return (math.prod(in_shape),)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return x.reshape(x.shape[0], -1)


class Reshape(Layer):
    """(B, ...) → (B, *target_shape)."""

    def __init__(self, target_shape: Sequence[int]):
        super().__init__()
        self.target_shape = tuple(int(d) for d in target_shape)

    def build(self, in_shape, generator, device):
        if math.prod(in_shape) != math.prod(self.target_shape):
            raise ValueError(
                f"Cannot reshape {tuple(in_shape)} to {self.target_shape}")
        return self.target_shape

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return x.reshape((x.shape[0],) + self.target_shape)


class Activation(Layer):
    """An activation by name, as a layer of its own."""

    def __init__(self, activation: str):
        super().__init__()
        self.activation = activation

    def build(self, in_shape, generator, device):
        return tuple(in_shape)

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return _apply_activation(self.activation, x)


class _RunningStats(nn.Module):
    """BatchNormalization's running statistics, the JAX params dict's
    ``"stats"`` entry: buffers ``mean`` (zeros) and ``var`` (ones),
    carried by the train step and never trained."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))


class BatchNormalization(Layer):
    """Batch norm over the trailing (channel) dim: f32 arithmetic, biased
    batch variance, result cast back to the input dtype.

    In train mode it normalizes with the batch statistics; through
    :meth:`apply_with_stats` it also returns Keras's EMA of the running
    statistics, ``momentum · moving + (1 − momentum) · batch``, which the
    train step writes back after the update (``Sequential.forward(...,
    stats_out=)`` collects them, ``Sequential.merge_stats`` writes them).
    In eval mode it normalizes with the running statistics."""

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)

    def build(self, in_shape, generator, device):
        c = in_shape[-1]
        self.scale = _param(torch.ones(c), device)
        self.offset = _param(torch.zeros(c), device)
        self.stats = _RunningStats(c, device)
        return tuple(in_shape)

    def _norm(self, x, train: bool):
        """(y, new statistics); the statistics are None in eval mode."""
        x32 = x.to(torch.float32)
        new_stats = None
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = x32.mean(dim=axes)
            var = x32.var(dim=axes, correction=0)
            with torch.no_grad():  # the JAX stop_gradient
                m = self.momentum
                new_stats = {
                    "mean": m * self.stats.mean + (1.0 - m) * mean,
                    "var": m * self.stats.var + (1.0 - m) * var}
        else:
            mean, var = self.stats.mean, self.stats.var
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.offset
        return y.to(x.dtype), new_stats

    def forward(self, x, compute_dtype=torch.bfloat16, train=False,
                generator=None):
        return self._norm(x, train)[0]

    def apply_with_stats(self, x, compute_dtype=torch.bfloat16):
        """The train-mode forward and the EMA-updated running statistics
        (``{"mean": ..., "var": ...}``)."""
        return self._norm(x, True)
