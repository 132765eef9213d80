"""The port's models (ResNet, VGG, MLP, BERT, GPT, Llama), exported under
the JAX package's names (``byteps_tpu/models/__init__.py``)."""

from .llama import (  # noqa: F401
    Llama,
    LlamaConfig,
    llama3_8b,
    llama_tiny,
)
from .mlp import MLP, mnist_mlp  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet,
    VGG,
    resnet18,
    resnet50,
    resnet_tiny,
    vgg16,
)
