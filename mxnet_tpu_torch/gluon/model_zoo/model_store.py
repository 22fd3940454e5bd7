"""Pretrained-weight store, as the JAX package's
``gluon/model_zoo/model_store.py``: a local directory, no download.

* The root is ``~/.mxnet/models``, ``$MXNET_HOME/models`` when
  ``MXNET_HOME`` is set, or the ``root=`` argument.
* It holds ``<name>.params`` files as ``Block.save_parameters`` writes
  them (the port's or the JAX package's: the two layouts agree), and
  ``pretrained=True`` loads them with ``load_parameters``.
* A missing file raises; nothing is fetched.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "load_pretrained"]


def _root(root=None):
    if root is not None:
        return os.path.expanduser(str(root))
    home = os.environ.get("MXNET_HOME")
    if home:
        return os.path.join(os.path.expanduser(home), "models")
    return os.path.expanduser(os.path.join("~", ".mxnet", "models"))


def get_model_file(name, root=None):
    """The path ``<root>/<name>.params``; raises when it is absent."""
    path = os.path.join(_root(root), f"{name}.params")
    if os.path.exists(path):
        return path
    raise MXNetError(
        f"pretrained weights for {name!r} not found at {path}. This "
        "build has no network access: place a Block.save_parameters-"
        "format file there (or set MXNET_HOME / pass root=...) to use "
        "pretrained=True.")


def load_pretrained(net, name, root=None, ctx=None):
    """Load ``net``'s weights from the store (on ``ctx``, default the
    current context); returns ``net``."""
    net.load_parameters(get_model_file(name, root), ctx=ctx)
    return net
