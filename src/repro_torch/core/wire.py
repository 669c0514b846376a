"""Entropy-coded wire format: the lossless second stage under the lossy sync.

Port of ``repro/core/wire.py``. Sync payloads are quantized to b-bit codes
(b in {4, 8}) with one symmetric fp32 scale per group, bit-packed into
uint32 words by the Hopper pack/unpack kernels (``kernels/pack.py``), and
unpacked and dequantized again. The bit width is fixed (``quant8``,
``quant4``) or follows the gradient entropy the controller measures
(``entropy``).

Training math is unchanged: every coded payload passes through an error
feedback loop. PowerSGD factors are coded by wrapping the injected
``psum_mean`` (``coded_psum``), so their quantization error lands in the
PowerSGD residual; flat-bucket members carry an explicit ``ef:<path>``
residual in the compressor state (``core/bucketing.py``).

Each member is coded on its own (own scales, own padding), so a member's
coded value does not depend on how the bucket is chunked. The collective
runs on the locally dequantized values (codes from different workers do
not sum); ``coded_bytes`` prices what a transport would ship: packed words
plus one fp32 scale per group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = [
    "WIRE_MODES", "ChunkCodec", "resolve_codec", "select_bits", "quantize",
    "dequantize", "roundtrip", "roundtrip_arr", "coded_psum", "coded_bytes",
    "predicted_code_bits",
]

F32 = torch.float32

#: SyncConfig.wire values. ``raw`` ships uncoded payloads; ``quant8`` /
#: ``quant4`` fix the bit width; ``entropy`` picks it per window from the
#: measured gradient entropy (quant8 until the first reading lands).
WIRE_MODES = ("raw", "quant8", "quant4", "entropy")

_LN2 = math.log(2.0)


@dataclass(frozen=True)
class ChunkCodec:
    """Static quantizer parameters for one sync payload (hashable, so it
    keys the trainer's step cache like a plan)."""

    bits: int = 8      # code width; 32 % bits == 0 (4 or 8 in practice)
    group: int = 1024  # elements per quantization scale

    def __post_init__(self):
        if 32 % self.bits != 0 or not (2 <= self.bits <= 16):
            raise ValueError(f"bits must divide 32 (got {self.bits})")
        if self.group < 1:
            raise ValueError(f"group must be >= 1 (got {self.group})")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


def select_bits(entropy_nats: float, ref_nats: float) -> int:
    """Map an entropy reading to a code width, anchored at 8 bits.

    The run's first reading (``ref_nats``) gets 8 bits; each nat below it
    sheds ~1.44 bits, and the value snaps to the widths the pack kernels
    take: 4 once the entropy has fallen ~1.4 nats below the start.
    """
    bits = 8 + (entropy_nats - ref_nats) / _LN2
    return 8 if bits >= 6 else 4


def resolve_codec(wire: str, entropy_nats: float | None = None,
                  ref_nats: float | None = None) -> ChunkCodec | None:
    """Static codec for a wire mode (None = raw/uncoded).

    ``entropy`` needs a reading and its run-start reference; with either
    missing it falls back to quant8.
    """
    if wire not in WIRE_MODES:
        raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
    if wire == "raw":
        return None
    if wire == "quant4":
        bits = 4
    elif wire == "quant8" or entropy_nats is None or ref_nats is None:
        bits = 8
    else:
        bits = select_bits(entropy_nats, ref_nats)
    # narrower codes get finer scale groups to hold the error down
    return ChunkCodec(bits=bits, group=256 if bits <= 4 else 1024)


# --------------------------------------------------------------- numerics
def _grouped(x: torch.Tensor, group: int) -> torch.Tensor:
    """Flat (n,) -> zero-padded (ceil(n / group), group)."""
    pad = (-x.shape[0]) % group
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, group)


def quantize(x: torch.Tensor, codec: ChunkCodec):
    """Flat fp32 (n,) -> (int32 codes (n,), fp32 per-group scales).

    Symmetric per-group quantization: scale = max|x| / qmax over each
    ``codec.group`` slice (an all-zero group gets scale 1), round half to
    even, clip to [-qmax, qmax], offset by +qmax so the codes are unsigned.
    A NaN element codes as 0, as XLA's float-to-int cast makes it on every
    device (a CPU cast here would give INT_MIN, whose sign bit lands in
    another slot of the packed word); a NaN group's scale is 1.
    """
    n = x.shape[0]
    grouped = _grouped(x.to(F32), codec.group)
    amax = grouped.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / codec.qmax,
                        torch.ones((), dtype=F32, device=x.device))
    q = torch.clamp(torch.round(grouped / scale), -codec.qmax, codec.qmax)
    codes = torch.nan_to_num(q + codec.qmax, nan=0.0)
    codes = codes.to(torch.int32).reshape(-1)[:n]
    return codes, scale[:, 0]


def dequantize(codes: torch.Tensor, scales: torch.Tensor,
               codec: ChunkCodec) -> torch.Tensor:
    """Inverse of quantize: codes (n,) + per-group scales -> fp32 (n,)."""
    n = codes.shape[0]
    q = _grouped(codes.to(F32) - codec.qmax, codec.group)
    return (q * scales[:, None]).reshape(-1)[:n]


def roundtrip(x: torch.Tensor, codec: ChunkCodec) -> torch.Tensor:
    """quantize -> pack -> unpack -> dequantize one flat fp32 vector.

    The pack/unpack leg is a bit-exact identity, but it runs the wire
    kernels, so the sync path does exactly what a transport would ship.
    """
    from repro_torch.kernels import pack

    codes, scales = quantize(x, codec)
    words = pack.pack_words(codes, codec.bits)
    back = pack.unpack_words(words, codec.bits, int(x.shape[0]))
    return dequantize(back, scales, codec)


def roundtrip_arr(x: torch.Tensor, codec: ChunkCodec | None) -> torch.Tensor:
    """roundtrip for a tensor of any shape, keeping its shape and dtype."""
    if codec is None:
        return x
    flat = x.to(F32).reshape(-1)
    return roundtrip(flat, codec).reshape(x.shape).to(x.dtype)


def coded_psum(psum_mean, codec: ChunkCodec | None):
    """Wrap a psum-mean so each worker's contribution is coded first."""
    if codec is None:
        return psum_mean
    return lambda a: psum_mean(roundtrip_arr(a, codec))


# ------------------------------------------------------------- accounting
def coded_bytes(n_elems: int, codec: ChunkCodec | None,
                raw_bytes_per_elem: int = 4) -> int:
    """Wire bytes for n payload elements: packed words + fp32 scales
    (``n * raw_bytes_per_elem`` with no codec)."""
    if n_elems <= 0:
        return 0
    if codec is None:
        return n_elems * raw_bytes_per_elem
    epw = 32 // codec.bits
    nwords = -(-n_elems // epw)
    ngroups = -(-n_elems // codec.group)
    return nwords * 4 + ngroups * 4


def predicted_code_bits(entropy_nats: float, step: float) -> float:
    """Model code entropy (bits/elem) of a quantized continuous source:
    H(Q(X)) ~ h(X) - log2(step) at high resolution."""
    if step <= 0:
        return 0.0
    return max(0.0, (entropy_nats - math.log(step)) / _LN2)
