"""Hopper kernels for the coded wire's bit packing, with their plain versions.

The CUDA C++ lives in ``csrc/pack.cu`` (built by ``build.py``, loaded with
``ctypes``). ``pack_words`` replaces ``repro/kernels/pack.py:42
pack_words`` and ``unpack_words`` replaces ``:61 unpack_words``; both
compute the flat function of ``repro/kernels/ops.py`` ``pack_bits`` /
``unpack_bits``: word w holds codes ``[w*epw, (w+1)*epw)`` in its b-bit
fields, low bits first (epw = 32 // b, b in {4, 8}), and the tail word is
zero-padded. The TPU's slot-major ``(epw, nwords)`` layout existed only so
its kernel could slice rows, and is not reproduced.

Design (H100 SXM: 3.35 TB/s HBM): one thread per word; 4 bytes of int32
code per element in, 4 bytes per word out, a few integer operations per
byte, so both kernels are bound by bytes. Each thread moves its codes as
16-byte vectors and the partial last word is masked, so every ``n`` runs
the kernel: unlike the reference (``ops.py:124,142``), payloads under 512
words do not go to the plain version.

A wrapper given CPU tensors runs its plain version (``ref.py``); given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["pack_words", "unpack_words", "KERNELS", "WIDTHS"]

#: Code widths the kernels take (each divides 32).
WIDTHS = (4, 8)
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("pack")
    if not getattr(lib, "_typed", False):
        for fn in (lib.repro_pack_words, lib.repro_unpack_words):
            fn.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _epw(bits: int) -> int:
    if bits not in WIDTHS:
        raise ValueError(f"bits={bits}: the pack kernels take {WIDTHS}")
    return 32 // bits


def pack_words(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Flat int32 codes (n,) -> uint32 words (ceil(n / (32 // bits)),)."""
    epw = _epw(bits)
    if _on_cpu(codes):
        return ref.pack_bits(codes, bits)
    if codes.ndim != 1 or codes.dtype != torch.int32:
        raise TypeError(f"want flat int32 codes, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    codes = codes.contiguous()
    n = codes.shape[0]
    words = torch.empty(-(-n // epw), dtype=torch.uint32, device=codes.device)
    if n:
        launch(_lib(), pack_words, "repro_pack_words", codes.device,
               _ptr(codes), _ptr(words), n, bits)
    return words


def unpack_words(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of ``pack_words``: uint32 words -> the first n int32 codes."""
    epw = _epw(bits)
    if _on_cpu(words):
        return ref.unpack_bits(words, bits, n)
    if words.ndim != 1 or words.dtype != torch.uint32:
        raise TypeError(f"want flat uint32 words, got {words.dtype} "
                        f"{tuple(words.shape)}")
    if not 0 <= n <= words.shape[0] * epw:
        raise ValueError(f"n={n} codes do not fit {words.shape[0]} words "
                         f"of {epw}")
    words = words.contiguous()
    codes = torch.empty(n, dtype=torch.int32, device=words.device)
    if n:
        launch(_lib(), unpack_words, "repro_unpack_words", words.device,
               _ptr(words), _ptr(codes), n, bits)
    return codes


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (pack_words, unpack_words)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
