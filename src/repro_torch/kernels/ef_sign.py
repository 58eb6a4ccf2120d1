"""Checked wrappers of the Hopper EF-sign bucket kernels (``csrc/ef_sign.cu``).

Each wrapper takes CUDA tensors only: it checks device, dtype, contiguity,
alignment and ``bucket_size % 32 == 0`` and raises on anything else,
allocates its outputs with ``torch.empty`` on the input's device, launches on
PyTorch's current stream, raises if the launch was refused, and adds one to
its ``launches`` count. Which path a tensor takes is decided in ``ops.py``:
CPU tensors go to the plain versions in ``ref.py``, CUDA tensors come here.

Sign words live in ``torch.int32`` storage; the kernels read and write them
as ``uint32``.

======================================  =========================================
kernel (this module)                    replaces (JAX package)
======================================  =========================================
:data:`bucket_stats`                    ``repro/kernels/ef_sign.py::bucket_stats``
:data:`bucket_ef_sign_compress`         ``repro/kernels/ef_sign.py::bucket_ef_sign_compress``
:data:`bucket_sign_decompress_mean`     ``repro/kernels/ef_sign.py::bucket_sign_decompress_mean``
======================================  =========================================
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import reciprocal_f32


class KernelError(RuntimeError):
    """A kernel launch was refused or failed (``cudaGetLastError`` != 0)."""


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int, device=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_bucket_size(bs: int) -> None:
    if bs <= 0 or bs % 32:
        raise ValueError(f"bucket_size must be a positive multiple of 32, got {bs}")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise KernelError(f"{name}: CUDA error {code} at launch")


class _Kernel:
    """A wrapper with a plain integer ``launches`` count."""

    name = ""

    def __init__(self):
        self.launches = 0


class _BucketStats(_Kernel):
    name = "bucket_stats"

    def __call__(self, g: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-bucket (Σ|g+e|, Σ(g+e)²): (nb, bs) f32 ×2 → 2×(nb,) f32."""
        _check("g", g, torch.float32, 2)
        _check("e", e, torch.float32, 2, g.device)
        if e.shape != g.shape:
            raise ValueError(f"e {tuple(e.shape)} != g {tuple(g.shape)}")
        nb, bs = g.shape
        _check_bucket_size(bs)
        l1 = torch.empty(nb, dtype=torch.float32, device=g.device)
        l2sq = torch.empty(nb, dtype=torch.float32, device=g.device)
        code = _build.library().ef_bucket_stats(
            g.data_ptr(), e.data_ptr(), l1.data_ptr(), l2sq.data_ptr(), nb, bs, _stream(g)
        )
        _raise_on(code, self.name)
        self.launches += 1
        return l1, l2sq


class _BucketEfSignCompress(_Kernel):
    name = "bucket_ef_sign_compress"

    def __call__(
        self, g: torch.Tensor, e: torch.Tensor, scales: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(nb, bs) g, e + (nb,) scales → ((nb, bs/32) int32 words, (nb, bs) f32 residual)."""
        _check("g", g, torch.float32, 2)
        _check("e", e, torch.float32, 2, g.device)
        _check("scales", scales, torch.float32, 1, g.device)
        nb, bs = g.shape
        if e.shape != g.shape or scales.shape[0] != nb:
            raise ValueError(
                f"shapes g {tuple(g.shape)} e {tuple(e.shape)} scales {tuple(scales.shape)}"
            )
        _check_bucket_size(bs)
        words = torch.empty((nb, bs // 32), dtype=torch.int32, device=g.device)
        e_new = torch.empty_like(g)
        code = _build.library().ef_bucket_sign_compress(
            g.data_ptr(), e.data_ptr(), scales.data_ptr(), words.data_ptr(), e_new.data_ptr(),
            nb, bs, _stream(g),
        )
        _raise_on(code, self.name)
        self.launches += 1
        return words, e_new


class _BucketSignDecompressMean(_Kernel):
    name = "bucket_sign_decompress_mean"

    def __call__(self, words: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        """(W, nb, bs/32) int32 words + (W, nb) f32 scales → (nb, bs) f32 mean."""
        _check("words", words, torch.int32, 3)
        _check("scales", scales, torch.float32, 2, words.device)
        w, nb, m = words.shape
        if tuple(scales.shape) != (w, nb):
            raise ValueError(f"scales {tuple(scales.shape)} != ({w}, {nb})")
        if w < 1:
            raise ValueError("need at least one sender")
        bs = m * 32
        out = torch.empty((nb, bs), dtype=torch.float32, device=words.device)
        code = _build.library().ef_bucket_decompress_mean(
            words.data_ptr(), scales.data_ptr(), out.data_ptr(), w, nb, bs,
            reciprocal_f32(w), _stream(words),
        )
        _raise_on(code, self.name)
        self.launches += 1
        return out


bucket_stats = _BucketStats()
bucket_ef_sign_compress = _BucketEfSignCompress()
bucket_sign_decompress_mean = _BucketSignDecompressMean()

KERNELS = (bucket_stats, bucket_ef_sign_compress, bucket_sign_decompress_mean)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
