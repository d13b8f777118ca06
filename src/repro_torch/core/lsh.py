"""Locality-sensitive hashing for the approximation index (paper C4).

Random-hyperplane signatures (Charikar's SimHash): bit i of sig(x) is
``1[r_i . x >= 0]`` for Gaussian hyperplanes r_i.  Then

    Pr[bit_i(x) != bit_i(y)] = angle(x, y) / pi

so with Hamming distance m over L bits,  cos(pi * m / L) ~= cosine(x, y)
and the paper approximates ``exp(w . d)`` by ``exp(cos(pi m / L))``
(Sec. III-B; vectors are unit length after the training modification).

Packed layout, shared with the JAX package bit for bit: bit j of word k
is signature bit 32*k + j.  Torch's ``uint32`` supports few ops, so the
packed words live in ``int32`` tensors that are views of the numpy
``uint32`` arrays (``arr.view(np.int32)``).  Shifts and masks on the
int32 view give the same bits as on uint32 (an arithmetic right shift
only fills bits that the masks drop), popcounts included.

Query signing in sym mode goes through ``sign_tensor``, which signs on
the host with ``sign_vectors_np`` (``ApproxIndex.query_sig_tensor``,
which ``MegascanSpec`` calls too, and ``LSHIndex``): a
flipped query bit moves the Hamming distance to every document by one,
so the bits must not depend on the device the index computes on.

Deviation from the JAX package: ``hyperplanes`` draws from a
``torch.Generator`` seeded with ``cfg.seed``.  It cannot reproduce
``jax.random``'s threefry stream, so an index built here from the same
seed has other planes than the JAX package's; the parity tests hand
both packages the same planes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    bits: int = 256        # lambda_2; paper uses 100, we use wider + see asym
    seed: int = 7

    @property
    def words(self) -> int:
        if self.bits % 32:
            raise ValueError(f"bits must be a multiple of 32, got {self.bits}")
        return self.bits // 32


def hyperplanes(cfg: LSHConfig, dim: int,
                device: "torch.device | str" = "cpu") -> torch.Tensor:
    """[bits, dim] float32 Gaussian hyperplanes from a ``torch.Generator``
    seeded with ``cfg.seed`` (fixed seed => reusable index).  Drawn on
    the CPU so the planes do not depend on the device, then moved."""
    gen = torch.Generator(device="cpu").manual_seed(int(cfg.seed))
    planes = torch.randn((cfg.bits, dim), generator=gen, dtype=torch.float32)
    return planes.to(device)


def signature_bits(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """[N, bits] uint8 of raw sign bits for row vectors ``x`` [N, dim]."""
    proj = x @ planes.T
    return (proj >= 0).to(torch.uint8)


_SHIFTS = torch.arange(32, dtype=torch.int64)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, bits] uint8 -> [N, bits//32] int32 (uint32 bit pattern), bit
    j of word k is signature bit 32*k + j (little-endian within the
    word).  Summed in int64 and narrowed, so bit 31 wraps to the sign
    bit exactly as the uint32 view reads it."""
    n, b = bits.shape
    if b % 32:
        raise ValueError(f"bit count must be a multiple of 32, got {b}")
    lanes = bits.reshape(n, b // 32, 32).to(torch.int64)
    words = (lanes << _SHIFTS.to(bits.device)).sum(dim=-1)
    return _narrow_u32(words)


def _narrow_u32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """[N, W] int32 packed words -> [N, bits] uint8."""
    n, w = packed.shape
    shifts = _SHIFTS.to(device=packed.device, dtype=torch.int32)
    out = (packed[:, :, None] >> shifts) & 1
    return out.reshape(n, w * 32)[:, :bits].to(torch.uint8)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of each 32-bit word (int32 tensor, uint32 bit pattern)
    -> int32 counts, by shifts and masks.  The arithmetic right shift of
    a negative word fills bits that the masks drop, so the counts are
    those of the uint32 words."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_distance(a_packed: torch.Tensor,
                     b_packed: torch.Tensor) -> torch.Tensor:
    """[N, W] x [M, W] -> [N, M] int32 Hamming distance (XOR+popcount)."""
    x = a_packed[:, None, :] ^ b_packed[None, :, :]
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def hamming_similarity(
    a_packed: torch.Tensor, b_packed: torch.Tensor, bits: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Paper Sec. III-B: approximate exp(beta * x . y) for unit vectors
    by exp(beta * cos(pi * m / L));  returns [N, M] float32."""
    m = hamming_distance(a_packed, b_packed).to(torch.float32)
    return torch.exp(temperature * torch.cos(math.pi * m / bits))


def asymmetric_cosine(
    query_vec: torch.Tensor,     # [dim] real-valued, any norm
    db_packed: torch.Tensor,     # [M, W] int32 signatures
    planes: torch.Tensor,        # [bits, dim]
    bits: int,
) -> torch.Tensor:
    """Asymmetric LSH scoring (index unchanged, noise ~1/2).

    E[(2 b_i(s) - 1) * r_i] = sqrt(2/pi) * s for unit s and Gaussian
    hyperplanes r_i, so

        cos(q, s) ~= sum_i (2 b_i(s) - 1) * (r_i . q_hat) / (L sqrt(2/pi))

    quantizes only the *stored* side; the query keeps its real
    projections.  Returns [M] estimated cosines (clipped to [-1, 1])."""
    q = query_vec / torch.clamp(torch.linalg.norm(query_vec), min=1e-9)
    proj = planes @ q                                     # [bits]
    signs = 2.0 * unpack_bits(db_packed, bits).to(torch.float32) - 1.0
    scale = 1.0 / (bits * math.sqrt(2.0 / math.pi))
    return torch.clamp(signs @ proj * scale, -1.0, 1.0)


# ---------------------------------------------------------------------------
# pure-numpy signing / distance for the serving hot path
#
# The semantic query cache (runtime/qcache) signs every incoming query
# vector per batch to form its key.  Operands are tiny ([B, dim] with B
# in the tens), where device dispatch would dominate the math, so the
# cache keys on this numpy replica of the signing convention:
# ``packbits`` little-endian + a uint32 view reproduces the in-word
# layout on the little-endian machines everything here runs on.
# ---------------------------------------------------------------------------

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def sign_vectors_np(vecs: np.ndarray, planes) -> np.ndarray:
    """[B, dim] float -> [B, bits//32] uint32 packed signatures, pure
    numpy, bit-identical to ``pack_bits(signature_bits(vecs, planes))``."""
    vecs = np.atleast_2d(np.asarray(vecs, np.float32))
    planes_np = np.asarray(planes, np.float32)
    bits = (np.asarray(vecs @ planes_np.T) >= 0)
    packed = np.packbits(bits, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32)


def packed_hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, W] x [M, W] packed uint32 -> [N, M] int32 Hamming distances
    (XOR + uint8-LUT popcount), pure numpy."""
    a2 = np.atleast_2d(np.asarray(a, np.uint32))
    b2 = np.atleast_2d(np.asarray(b, np.uint32))
    x = np.bitwise_xor(a2[:, None, :], b2[None, :, :])
    per_byte = _POPCOUNT8[np.ascontiguousarray(x).view(np.uint8)]
    return per_byte.reshape(a2.shape[0], b2.shape[0], -1).sum(
        axis=-1, dtype=np.int32)


def to_packed_tensor(sig, device: "torch.device | str" = "cpu") -> torch.Tensor:
    """Packed signatures (numpy uint32/int32 or a torch tensor) -> the
    int32 tensor view the port computes on, on ``device``."""
    if isinstance(sig, torch.Tensor):
        if sig.dtype == torch.uint32:
            sig = sig.view(torch.int32)
        if sig.dtype != torch.int32:
            raise TypeError(f"packed signatures must be 32-bit, got {sig.dtype}")
        return sig.to(device)
    arr = np.ascontiguousarray(sig)
    if arr.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed signatures must be 32-bit, got {arr.dtype}")
    return torch.tensor(arr.view(np.int32), device=device)


def to_numpy_u32(packed: torch.Tensor) -> np.ndarray:
    """int32 packed tensor -> numpy uint32 array (the reference layout)."""
    return packed.detach().cpu().numpy().view(np.uint32)


def sign_tensor(x, planes: torch.Tensor) -> torch.Tensor:
    """[N, dim] vectors (array or tensor) -> [N, bits//32] int32 packed
    signatures on ``planes``' device, signed on the host by
    ``sign_vectors_np`` so the bits do not depend on the device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return to_packed_tensor(
        sign_vectors_np(x, planes.detach().cpu().numpy()), planes.device)


class LSHIndex(NamedTuple):
    """Packed signatures + the hyperplanes that produced them, on the
    planes' device."""
    packed: torch.Tensor   # [N, bits//32] int32 (uint32 bit pattern)
    planes: torch.Tensor   # [bits, dim] float32
    bits: int

    @staticmethod
    def build(x, cfg: LSHConfig,
              device: "torch.device | str" = "cuda") -> "LSHIndex":
        """Sign the rows of ``x`` under planes drawn from ``cfg.seed``
        (``hyperplanes``), kept on ``device``: CUDA unless the caller
        asks for the CPU (asking for CUDA without a GPU raises)."""
        from repro_torch.kernels.common import resolve_device
        device = resolve_device(device)
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.atleast_2d(np.asarray(x, np.float32))
        planes = hyperplanes(cfg, x.shape[-1], device)
        return LSHIndex(sign_tensor(x, planes), planes, cfg.bits)

    def sign(self, x) -> torch.Tensor:
        """Signature for new vectors under the same hyperplanes ([dim]
        or [N, dim]; always [N, bits//32])."""
        return sign_tensor(x, self.planes)

    def similarities(self, query_vec, temperature: float = 1.0
                     ) -> torch.Tensor:
        """exp-cosine similarity of ``query_vec`` to every indexed item,
        [N] float32: the Hamming similarity kernel on a CUDA index, its
        plain version on a CPU one (the JAX package's ``use_kernel``
        flag has no counterpart)."""
        from repro_torch.kernels.hamming import ops as hamming_ops
        q = self.sign(query_vec)
        return hamming_ops.hamming_similarity(
            q, self.packed, self.bits, temperature=temperature)[0]
