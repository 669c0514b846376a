"""EDGC on PyTorch and CUDA (Hopper): the port of the JAX package ``repro``.

The layout mirrors ``repro`` (``core/``, ``kernels/``, ``models/``,
``optim/``, ``train/``, ``launch/``, ``configs/``, ``data/``, ``dist/``) so
each module's counterpart is found under the same name. Nothing here
imports JAX or ``repro``; only the tests import both packages.
"""
