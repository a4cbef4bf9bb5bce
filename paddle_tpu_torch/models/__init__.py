"""Models built on the port's layers."""
from . import (ctr, llama, mnist, resnet, se_resnext, simple,  # noqa: F401
               stacked_lstm, transformer, vgg, word2vec)
