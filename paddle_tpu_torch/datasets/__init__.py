"""Datasets with the paddle.v2.dataset surface: the port's own copies of
the JAX package's datasets (no import of it), record for record.

Zero-egress: every module is backed by a deterministic synthetic generator
with the real data's record shapes and vocabularies; real files under
common.DATA_HOME are used where a loader exists (mnist, cifar, imdb,
imikolov, uci_housing, movielens' ml-1m.zip). See common.py.
"""
from . import common
from . import uci_housing
from . import mnist
from . import cifar
from . import imdb
from . import imikolov
from . import movielens
from . import conll05
from . import wmt14
from . import wmt16
from . import mq2007
from . import sentiment
from . import flowers
from . import voc2012

__all__ = ["common", "uci_housing", "mnist", "cifar", "imdb", "imikolov",
           "movielens", "conll05", "wmt14", "wmt16", "mq2007", "sentiment",
           "flowers", "voc2012"]
