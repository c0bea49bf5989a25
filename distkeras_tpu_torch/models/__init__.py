"""Model zoo of the port (counterpart of ``distkeras_tpu.models``)."""

from .zoo import (cifar10_convnet, digits_convnet, digits_mlp, higgs_mlp,
                  mnist_convnet, mnist_mlp, transformer_lm)

__all__ = ["mnist_mlp", "mnist_convnet", "cifar10_convnet", "higgs_mlp",
           "digits_mlp", "digits_convnet", "transformer_lm"]
