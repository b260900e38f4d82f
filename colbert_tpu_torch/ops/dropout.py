"""Byte-threshold dropout whose mask is regenerated in the backward pass (K9).

Counterpart of ``colbert_tpu/ops/dropout_pallas.py`` (``hw_dropout``, a
custom VJP around the Pallas ``_kernel``) and of the byte semantics of
``FastDropout`` (``colbert_tpu/models/bert.py:32-73``):

    thr   = round(rate * 256)                      (drop probability thr / 256)
    y     = where(byte >= thr, x * scale, 0)       scale = 256 / (256 - thr), in x's dtype
    dx    = where(byte >= thr, dy * scale, 0)      the same bytes, regenerated

The mask bytes come from Philox4x32-10 keyed by a 64-bit per-call seed and
counted by groups of 16 elements from a counter ``base`` (``csrc/dropout.cu``
documents the stream): a data-parallel rank passes the group where its rows
start in the global batch, and so draws the masks one device draws for
them.  A tensor-parallel position holds a slice of each row (its heads of
the attention probabilities, its columns of the attention output): its
groups come in runs of ``inner``, run r drawn from counter ``base + r *
stride`` on (:func:`slice_groups`), so it too draws one device's masks.
The TPU kernel uses the TPU's hardware generator; the streams differ and
need not agree, the semantics do.  Nothing is saved between the passes but
the seed.

:func:`hw_dropout` launches the CUDA kernel for CUDA tensors (forward and
backward, each counted in ``hw_dropout.launches`` and, by route, in
``route_launches``) and runs :func:`hw_dropout_ref`, the plain PyTorch
version of the same stream, for CPU tensors.  On the card the two are equal
bit for bit.  The kernel has two routes (``csrc/dropout.cu``): "packed",
the default, and the first design, "simple", only through
``_launch(..., route="simple")``.  A call's host path is short because
the hidden states' launch takes ~0.01 ms on the card: the scale is cached
per ``(thr, dtype)``, the C function and its argtypes are resolved once,
the stream is read raw and the C function switches the device only when it
must.  :func:`same_bits` is how the kernel is held to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def threshold(rate: float) -> int:
    """Drop threshold in 1/256 units: ``round(rate * 256)`` as the JAX package takes it."""
    return int(round(rate * 256))


def keep_scale(thr: int, dtype: torch.dtype) -> float:
    """``256 / (256 - thr)`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(256.0 / (256.0 - thr), dtype=torch.float64).to(dtype))


# ---- the Philox stream in torch integer ops (int64 lanes holding uint32) ----

def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32 bits of ``a * b`` for a constant ``a < 2**32`` and
    ``b`` in [0, 2**32), without leaving int64: ``b`` splits into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)                      # < 2**48
    p_hi = a * (b >> 16)                         # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)         # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on four int64 tensors holding uint32 words (``counter``)
    and two Python ints (``key``).  Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def slice_groups(groups: int, base: int = 0, inner: int = 0, stride: int = 0, device=None) -> torch.Tensor:
    """The Philox counter of each of a call's ``groups`` groups: ``base + i``,
    or, for a slice (``inner`` > 0), ``base + (i // inner) * stride + i % inner``."""
    i = torch.arange(groups, dtype=torch.int64, device=device)
    if inner and stride != inner:
        i = torch.div(i, inner, rounding_mode="floor") * stride + i % inner
    return i + base


def divisor_magic(d: int):
    """``(mul, shr)`` with ``g // d == (g * mul) >> (32 + shr)`` for every
    ``0 <= g < 2**31`` (``d >= 2``): the round-up method the kernel divides
    by (``csrc/dropout.cu``, ``Slice``); ``(0, 0)`` for ``d == 1``."""
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()  # ceil(log2 d)
    return -(-(1 << (31 + lg)) // d), lg - 1


def mask_bytes(n: int, seed: int, device=None, base: int = 0, inner: int = 0, stride: int = 0) -> torch.Tensor:
    """The kernel's ``n`` mask bytes for ``seed`` (uint8): element ``16*i + j``
    takes byte ``j % 4`` (low first) of word ``j // 4`` of the Philox output
    at group ``i``'s counter (:func:`slice_groups`)."""
    groups = -(-n // 16)
    i = slice_groups(groups, base, inner, stride, device)
    zero = torch.zeros_like(i)
    words = torch.stack(philox4x32_10((i & _MASK32, i >> 32, zero, zero),
                                      (seed & _MASK32, seed >> 32)), dim=1)       # (groups, 4)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    return ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)[:n]


def hw_dropout_ref(x: torch.Tensor, seed: int, thr: int, base: int = 0, inner: int = 0,
                   stride: int = 0) -> torch.Tensor:
    """Plain version of the kernel: the same bytes, the same arithmetic."""
    keep = mask_bytes(x.numel(), seed, x.device, base, inner, stride).view(x.shape) >= thr
    scale = torch.tensor(keep_scale(thr, x.dtype), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same bits, NaNs compared by position only."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    na, nb = a.isnan(), b.isnan()
    return a.shape == b.shape and torch.equal(na, nb) and torch.equal(
        torch.where(na, 0, a.view(ints)), torch.where(nb, 0, b.view(ints)))


# ---- the CUDA kernel ----

#: the kernel's routes: "packed" (the default) and the first design, "simple", on request only
ROUTES = ("packed", "simple")
_ROUTE_CODES = {r: i for i, r in enumerate(ROUTES)}
_scales = {}  # (thr, dtype) -> keep_scale(thr, dtype)
_fn = None  # dropout_launch_slice with its argtypes, resolved at first use
_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("dropout")
    with _lib_lock:
        if lib.dropout_launch.argtypes is None:
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
                    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.dropout_launch_slice.argtypes = [*args, ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_ulonglong,
                                                 ctypes.c_uint, ctypes.c_uint]
            lib.dropout_launch_slice.restype = ctypes.c_int
            lib.dropout_launch.argtypes = args
            lib.dropout_launch.restype = ctypes.c_int
    return lib


def _scale(thr: int, dtype: torch.dtype) -> float:
    """:func:`keep_scale`, computed once for each ``(thr, dtype)``."""
    s = _scales.get((thr, dtype))
    if s is None:
        s = _scales[(thr, dtype)] = keep_scale(thr, dtype)
    return s


def _launch(x: torch.Tensor, seed: int, thr: int, route: str = "packed", base: int = 0, inner: int = 0,
            stride: int = 0) -> torch.Tensor:
    global _fn
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"dropout kernel takes float32, bfloat16 or float16, got {x.dtype}")
    sliced = bool(inner) and stride != inner
    if (base or sliced) and route != "packed":
        raise ValueError(f"route {route!r} draws from counter 0 only (base {base}, a slice {sliced})")
    if sliced and -(-x.numel() // 16) >= 1 << 31:
        raise ValueError(f"a slice's call takes fewer than 2**31 groups, got {-(-x.numel() // 16)}")
    x = x.contiguous()
    y = torch.empty_like(x)
    dev = x.get_device()
    # the C function makes `dev` current for the launch if it is not
    args = (x.data_ptr(), y.data_ptr(), x.numel(), code, seed, thr, _scale(thr, x.dtype), _ROUTE_CODES[route],
            dev, torch._C._cuda_getCurrentRawStream(dev))
    if _fn is None:
        _fn = _kernel_lib().dropout_launch_slice
    err = _fn(*args, base, inner, stride, *(divisor_magic(inner) if sliced else (0, 0)))
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: cudaError_t {err}")
    hw_dropout.launches.add()
    route_launches[route].add()
    if sliced:
        slice_launches.add()
    return y


def _apply(x: torch.Tensor, seed: int, thr: int, base: int = 0, inner: int = 0, stride: int = 0) -> torch.Tensor:
    if x.is_cpu:
        return hw_dropout_ref(x, seed, thr, base, inner, stride)
    return _launch(x, seed, thr, base=base, inner=inner, stride=stride)


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, thr, base, inner, stride):
        ctx.seed, ctx.thr, ctx.base, ctx.inner, ctx.stride = seed, thr, base, inner, stride
        return _apply(x, seed, thr, base, inner, stride)

    @staticmethod
    def backward(ctx, grad):
        # same mask, same scale: regenerated from the seed, never stored
        return _apply(grad, ctx.seed, ctx.thr, ctx.base, ctx.inner, ctx.stride), None, None, None, None, None


def hw_dropout(x: torch.Tensor, seed: int, thr: int, base: int = 0, inner: int = 0, stride: int = 0) -> torch.Tensor:
    """Dropout with drop probability ``thr / 256``; ``seed`` is an int in
    [0, 2**64) drawn once per call site, ``base`` the Philox counter of the
    first 16 elements.  ``inner`` > 0: ``x`` is a slice of a larger
    tensor, its groups in runs of ``inner``, run r drawn from counter ``base
    + r * stride`` on (``stride >= inner``).  Differentiable in ``x``."""
    if not 1 <= thr <= 255:
        raise ValueError(f"dropout threshold must be 1..255 (of 256), got {thr}")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"dropout seed must fit 64 bits unsigned, got {seed}")
    if not 0 <= base < 1 << 64:
        raise ValueError(f"dropout counter base must fit 64 bits unsigned, got {base}")
    if inner < 0 or (inner and stride < inner):
        raise ValueError(f"a slice's runs need 0 < inner <= stride, got inner {inner}, stride {stride}")
    return _HwDropout.apply(x, seed, thr, base, inner, stride)


hw_dropout.launches = LaunchCounter()
#: K9's launches on a slice's strided counters (forward and backward each count once)
slice_launches = LaunchCounter()
#: K9's launches by route (forward and backward each count once)
route_launches = {r: LaunchCounter() for r in ROUTES}
