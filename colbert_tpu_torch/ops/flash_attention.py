"""Flash attention with segment-id masking (K11 forward, K12 dK/dV, K13 dQ).

Counterpart of ``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``
as ``colbert_tpu/models/bert.py:181-200`` calls it under
``model.attention_impl="flash"``: q, k, v (B, nh, L, hd), segment ids
(B, L) int32, ``sm_scale``, no bias, not causal.  Its three ``pallas_call``s
(jax 0.9.0, ``jax/experimental/pallas/ops/tpu/flash_attention.py``) are the
forward (``_flash_attention_kernel``, ``pallas_call`` at :758), the dK/dV
backward (``_flash_attention_dkv_kernel``, :1121) and the dQ backward
(``_flash_attention_dq_kernel``, :1456).  What they compute, which this
module keeps:

* the mask is segment equality: key j is visible to query i iff
  ``q_seg[i] == kv_seg[j]`` (a padded query attends to the padded keys);
* ``s = (q . k) * sm_scale + (0 if visible else MASK_VALUE)``, the products
  in fp32, ``MASK_VALUE = -0.7 * FLT_MAX`` added (never -inf, so a row whose
  first key block is all masked makes no ``inf - inf``);
* the forward walks the keys in blocks of 128 with a running max ``m`` and
  sum ``l``: ``p = exp(s - m_next)``, rounded to v's dtype before ``p . v``
  (fp32 accumulation); the accumulator is kept normalised, ``acc = acc *
  (alpha * l_prev / l_next) + (p . v) / l_next``; with a single block (L
  128) ``p`` is divided by ``l`` before the rounding instead; the output is
  rounded once, and ``l`` and ``m`` per row are saved;
* the backward: ``di = sum(o * do)`` in fp32 (outside the kernels, as in
  JAX), ``p = exp(s - m) * (1 / l)``, ``dv += p^T . do`` and ``dk += ds^T .
  q`` with ``ds = (do . v^T - di) * p * sm_scale`` (both casts to the input
  dtype before the product), ``dq += ds . k``; dq, dk, dv rounded at the end.

:func:`flash_attention` is a ``torch.autograd.Function``: for CPU tensors
the plain versions (:func:`flash_forward_ref`, :func:`flash_backward_ref`
on :func:`flash_di`, which keep the JAX kernels' order: 128-key blocks,
running ``m`` and ``l``); for CUDA tensors the kernels of
``csrc/flash_attention.cu``: forward K11; backward the rows kernel (di read
once from o and do in their dtype, summed in fp32 in
:func:`flash_di_card_order`'s order, and 1 / l), then K12, then K13 (no
atomics, so every run gives the same bits).  On bf16 and fp16 inputs K11,
K12 and K13 have two routes (:data:`ROUTES`): "wgmma", the default, and the
first design, "simple", only when a caller asks for it; fp32 inputs take
route "tf32" (:data:`TF32_ROUTE`: each product as three TF32 products on
the tensor cores) in K11, K12 and K13, and only it; the rows kernel reads
fp32 o and do in fp32 on the CUDA cores.  K12 and K13 on routes "wgmma"
and "tf32" read the rows kernel's 1 / l.  Each launch is counted in its
``LaunchCounter`` (:data:`fwd_launches`, :data:`dkv_launches`,
:data:`dq_launches`, :data:`rows_launches`, by route
:data:`fwd_route_launches`, :data:`dkv_route_launches`,
:data:`dq_route_launches`, by head dim :data:`fwd_head_dim_launches`,
:data:`dkv_head_dim_launches`, :data:`dq_head_dim_launches`, and the rows
kernel's fp32 launches :data:`rows_fp32_launches`); a shape they do not take raises
``NotImplementedError`` (:func:`kernel_refusal`), and a failed launch raises.
The kernels take every head dim from 1 to 128 (:data:`MAX_HEAD_DIM`): each
runs on the least of the templates :data:`HEAD_DIMS` (32, 64, 128, each an
instantiation in the .cu) that holds it (:func:`template_head_dim`), the
columns past it zeros in shared memory alone; launches are counted by both
(:data:`fwd_head_dim_launches`, :data:`fwd_template_launches`, ...).  The
multiples of 128 above 128, which the JAX kernel also takes, are refused.
Route "simple" takes 64 alone.  Inputs are read in their own layout (unit
stride along the head dim): where a head's rows are 16-byte aligned the
kernels' tensor maps load them, elsewhere (hd 26 in bf16) the kernels'
producer warps copy them; no padded copy is made outside the kernels.
Outputs and gradients are (B, nh, L, hd) views of (B, L, nh, hd) buffers,
the layout the model's heads come from, so its reshapes copy nothing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the JAX kernel's DEFAULT_MASK_VALUE
BLOCK = 128  # the JAX kernels' key (and query) block; L must be a multiple of it on the card
HEAD_DIMS = (32, 64, 128)  # the kernels' templates: a head dim runs on the least that holds it
MAX_HEAD_DIM = HEAD_DIMS[-1]  # the kernels take head dims 1 .. 128; the .cu's flash_head_dim_template() agrees
SIMPLE_HEAD_DIM = 64  # route "simple"'s one head dim
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


# ---- plain PyTorch versions (the JAX kernels' order) ----

def _masked_logits(q, k_blk, q_seg, kv_seg_blk, sm_scale: float) -> torch.Tensor:
    """(B, nh, Lq, n) fp32 logits of one key block: scaled, then the mask added."""
    s = torch.matmul(q.float(), k_blk.float().transpose(-1, -2)) * sm_scale
    visible = (q_seg[:, None, :, None] == kv_seg_blk[:, None, None, :])
    return s + torch.where(visible, 0.0, MASK_VALUE)


def flash_forward_ref(q, k, v, q_seg, kv_seg, sm_scale: float):
    """(o, l, m): o like q, l and m (B, nh, Lq) fp32; the JAX forward's arithmetic."""
    Lk = k.shape[2]
    if Lk <= BLOCK:  # the JAX kernel's single-step form: p normalised before the rounding
        s = _masked_logits(q, k, q_seg, kv_seg, sm_scale)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        p = p / l[..., None]
        o = torch.matmul(p.to(v.dtype).float(), v.float())
        return o.to(q.dtype), l, m
    B, nh, Lq, hd = q.shape
    m = torch.full((B, nh, Lq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nh, Lq, v.shape[-1]), dtype=torch.float32, device=q.device)
    for lo in range(0, Lk, BLOCK):
        s = _masked_logits(q, k[:, :, lo:lo + BLOCK], q_seg, kv_seg[:, lo:lo + BLOCK], sm_scale)
        m_next = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_next[..., None])
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(-1) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, torch.ones_like(l_next) / l_next)
        acc = acc * (l_corr * inv)[..., None]
        acc = acc + torch.matmul(p.to(v.dtype).float(), v[:, :, lo:lo + BLOCK].float()) * inv[..., None]
        m, l = m_next, l_next
    return acc.to(q.dtype), l, m


def flash_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``sum(o * do)`` over the head dim in fp32: the JAX backward's di (computed outside its kernels)."""
    return (o.float() * do.float()).sum(-1)


def flash_di_card_order(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """:func:`flash_di` in the order the card's rows kernel sums it: each
    8-element chunk of a row (a lane's) in order from 0, then the t / 8
    chunk sums pairwise at distance t / 16, ..., 2, 1 (its lanes'
    shuffles), t the head dim's template (:func:`template_head_dim`; the
    products past the head dim are zeros).  The products of two bf16 or
    fp16 values are exact in fp32, so only the order rounds; fp32 products
    round once each, here as on the card."""
    hd = o.shape[-1]
    x = o.float() * do.float()
    t = template_head_dim(hd) or hd
    x = torch.nn.functional.pad(x, (0, t - hd)).unflatten(-1, (-1, 8))
    c = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for e in range(8):
        c = c + x[..., e]
    while c.shape[-1] > 1:
        half = c.shape[-1] // 2
        c = c[..., :half] + c[..., half:]
    return c[..., 0]


def flash_backward_ref(q, k, v, q_seg, kv_seg, sm_scale: float, l, m, do, di):
    """(dq, dk, dv) like q, k, v: the JAX dK/dV and dQ kernels' arithmetic,
    the products summed by 128 x 128 blocks as they sum them."""
    Lq, Lk = q.shape[2], k.shape[2]
    inv_l = torch.ones_like(l) / l
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for klo in range(0, Lk, BLOCK):
        ks, kk, vv = slice(klo, klo + BLOCK), k[:, :, klo:klo + BLOCK], v[:, :, klo:klo + BLOCK]
        for qlo in range(0, Lq, BLOCK):
            qs = slice(qlo, qlo + BLOCK)
            s = _masked_logits(q[:, :, qs], kk, q_seg[:, qs], kv_seg[:, ks], sm_scale)
            p = torch.exp(s - m[:, :, qs, None]) * inv_l[:, :, qs, None]
            dv[:, :, ks] += torch.matmul(p.transpose(-1, -2).to(do.dtype).float(), do[:, :, qs].float())
            dp = torch.matmul(do[:, :, qs].float(), vv.float().transpose(-1, -2))
            ds = (dp - di[:, :, qs, None]) * p * sm_scale
            dk[:, :, ks] += torch.matmul(ds.transpose(-1, -2).to(do.dtype).float(), q[:, :, qs].float())
            dq[:, :, qs] += torch.matmul(ds.to(k.dtype).float(), kk.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at ``|x|``."""
    _, e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(x), e - 8)


def close_in_head_ulps(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float, float]:
    """How the kernels are held to the plain versions: (the largest error in
    bf16 ulps of its head vector's magnitude, floored at 2^-10 of the
    tensor's largest entry; the share of elements beyond 2 ulps of their own
    magnitude; the largest absolute error)."""
    a, b = got.float(), want.float()
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    err = (a - b).abs()
    mag = torch.maximum(a.abs(), b.abs())
    row = mag.amax(-1, keepdim=True).clamp_min(2.0**-10 * float(mag.max()))
    return (float((err / bf16_ulp(row)).max()), float((err > 2 * bf16_ulp(mag)).float().mean()),
            float(err.max()))


#: route "tf32" (K11, K12, K13) against the fp32 plain version: the
#: largest error relative to each head vector's magnitude
#: (:func:`fp32_head_rel`)
FP32_HEAD_REL = 1e-5


def fp32_head_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """How route "tf32" is held to the fp32 plain version: the largest
    error over its head vector's largest magnitude, floored at 2^-3 of the
    tensor's largest entry.  Three TF32 products differ from the plain
    version in summation order, the exponential's last bits, the dropped lo
    * lo and lo's rounding (~2^-21 of a product), but a query whose segment
    holds few keys has ds = (dp - di) p
    from two fp32 sums of the same 64 products, which cancel to fp32 noise
    (~eps |do| |v|) in either order: the floor allows that noise,
    FP32_HEAD_REL / 8 of the tensor's largest entry, and no more."""
    a, b = got.float(), want.float()
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    mag = torch.maximum(a.abs(), b.abs())
    row = mag.amax(-1, keepdim=True).clamp_min(2.0**-3 * float(mag.max()))
    return float(((a - b).abs() / row).max())


# ---- the CUDA kernels ----

_lib_lock = threading.Lock()
_VIEW = ctypes.c_longlong * 3
_resolved = None  # (forward, dK/dV, dQ, rows) C functions, see _fns
#: K11's, K12's and K13's routes on bf16 and fp16: "wgmma" (every shape the
#: kernels take) and the first design, "simple", on request only
ROUTES = ("wgmma", "simple")
#: K11's, K12's and K13's route for fp32 inputs: three TF32 products on wgmma
TF32_ROUTE = "tf32"
_ROUTE_CODES = {"simple": 0, "wgmma": 1, TF32_ROUTE: 3}


def template_head_dim(hd: int) -> Optional[int]:
    """The template (:data:`HEAD_DIMS`) head dim ``hd`` runs on: the least
    that holds it; None below 1 and past :data:`MAX_HEAD_DIM`."""
    return next((t for t in HEAD_DIMS if hd <= t), None) if hd >= 1 else None


def kernel_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why the kernels do not take these CUDA inputs, or None: they take bf16,
    fp16 or fp32 (one dtype for all three), head dims 1 to 128 (one for all
    three; the JAX kernel's multiples of 128 above it are refused), any B
    and nh, and q and kv lengths that are multiples of 128 (the JAX kernel's
    block)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        return f"dtypes {q.dtype}, {k.dtype}, {v.dtype} (the kernels take bf16, fp16 or fp32)"
    hd = q.shape[-1]
    if template_head_dim(hd) is None or k.shape[-1] != hd or v.shape[-1] != hd:
        return (f"head dim {hd} (k {k.shape[-1]}, v {v.shape[-1]}; the kernels take 1 to {MAX_HEAD_DIM})")
    if q.shape[2] % BLOCK or k.shape[2] % BLOCK or q.shape[2] == 0 or k.shape[2] == 0:
        return f"lengths {q.shape[2]}, {k.shape[2]} (the kernels take multiples of {BLOCK})"
    return None


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    with _lib_lock:
        if lib.flash_fwd_launch.argtypes is None:
            bind(lib)
    return lib


def bind(lib: ctypes.CDLL, check: bool = True) -> None:
    """Set the C entry points' argtypes on a library built from
    ``csrc/flash_attention.cu``; with ``check``, RuntimeError unless its rule
    for the head dims (``flash_head_dim_template``: the template each runs
    on, 0 for one it refuses) is :func:`template_head_dim`'s at every head
    dim from 0 to 2 * :data:`MAX_HEAD_DIM` + 1."""
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if check:
        rule = lib.flash_head_dim_template
        rule.argtypes, rule.restype = [i], i
        off = {hd: rule(hd) for hd in range(2 * MAX_HEAD_DIM + 2) if rule(hd) != (template_head_dim(hd) or 0)}
        if off:
            raise RuntimeError(f"csrc/flash_attention.cu runs head dims on other templates than "
                               f"ops/flash_attention.py's rule: {off}")
    tail = [i, i, i, i, i, f, i, i, ptr]  # B, nh, Lq, Lk, hd, sm_scale, dtype, device, stream
    routed = tail[:7] + [i] + tail[7:]  # ..., dtype, route, device, stream
    lib.flash_fwd_launch.argtypes = [ptr] * 8 + [_VIEW] * 4 + routed
    lib.flash_bwd_dkv_launch.argtypes = [ptr] * 12 + [_VIEW] * 6 + routed
    lib.flash_bwd_dq_launch.argtypes = [ptr] * 11 + [_VIEW] * 5 + routed
    lib.flash_bwd_rows_launch.argtypes = [ptr] * 5 + [_VIEW] * 2 + [i, i, i, i, i, i, ptr]
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_rows_launch):
        fn.restype = i


def _fns():
    """The four C entry points with their argtypes, resolved at first use."""
    global _resolved
    if _resolved is None:
        lib = _kernel_lib()
        _resolved = (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch, lib.flash_bwd_dq_launch,
                     lib.flash_bwd_rows_launch)
    return _resolved


def _view(t: torch.Tensor):
    """(B, nh, L, hd) strides in elements (batch, head, row) for the kernels."""
    return _VIEW(t.stride(0), t.stride(1), t.stride(2))


def _kernel_input(t: torch.Tensor, route: str = "wgmma") -> torch.Tensor:
    """``t`` as the kernels read it: unit stride along the head dim, any
    other strides (routes "wgmma" and "tf32" and the rows kernel read a
    head's rows with tensor maps where they are 16-byte aligned, else by
    their own copies); route "simple" also 16-byte rows (strides multiples
    of 8 elements), 16-byte aligned; else a contiguous copy."""
    ok = t.stride(3) == 1 and (route != "simple" or (t.data_ptr() % 16 == 0
                                                     and all(s % 8 == 0 for s in t.stride()[:3])))
    return t if ok else t.contiguous()


def _heads_major(B: int, nh: int, L: int, hd: int, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, nh, L, hd) view of a (B, L, nh, hd) buffer."""
    return torch.empty((B, L, nh, hd), dtype=like.dtype, device=like.device).transpose(1, 2)


def _check(err: int, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed for q {tuple(q.shape)} {q.dtype}: "
                           f"cudaError_t {err}")


def _segments(q_seg: torch.Tensor, kv_seg: torch.Tensor, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous, 16-byte aligned int32 segment ids on ``device``."""
    def one(t):
        t = t.to(device=device, dtype=torch.int32).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()
    return one(q_seg), one(kv_seg)


def kernel_route(dtype: torch.dtype, route: Optional[str] = None, backward: bool = False) -> str:
    """The route K11 (``backward`` False) or K12 and K13 (True) take for
    ``dtype``: ``route`` (bf16 and fp16: "wgmma" if None, or "simple"; fp32:
    "tf32" only, forward and backward), else ValueError.  Route "simple"
    takes head dim 64 alone (:func:`_route`)."""
    if dtype == torch.float32:
        if route not in (None, TF32_ROUTE):
            what = "backward" if backward else "forward"
            raise ValueError(f"fp32 inputs take the {what} route {TF32_ROUTE!r} only, not {route!r}")
        return TF32_ROUTE
    route = route or "wgmma"
    if route not in ROUTES:
        raise ValueError(f"{dtype} inputs take the routes {ROUTES}, not {route!r}")
    return route


def _route(q: torch.Tensor, route: Optional[str], backward: bool = False) -> str:
    """:func:`kernel_route` for q's dtype; NotImplementedError for route
    "simple" at a head dim but 64, which only routes "wgmma" and "tf32" take."""
    route = kernel_route(q.dtype, route, backward)
    if route == "simple" and q.shape[-1] != SIMPLE_HEAD_DIM:
        raise NotImplementedError(f"flash attention route 'simple' takes head dim {SIMPLE_HEAD_DIM} only, not "
                                  f"{q.shape[-1]} (routes 'wgmma' and 'tf32' take 1 to {MAX_HEAD_DIM})")
    return route


def _device_stream(t: torch.Tensor) -> Tuple[int, int]:
    """``t``'s card and its current stream, raw: the C entry makes the card
    current for the launch only if it is not."""
    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def _launch_forward(q, k, v, q_seg, kv_seg, sm_scale: float, route: Optional[str] = None):
    """K11: (o, l, m), o a (B, nh, Lq, hd) view of a (B, Lq, nh, hd) buffer;
    ``route`` as :func:`kernel_route` takes it."""
    launch = _fns()[0]
    route = _route(q, route)
    q, k, v = (_kernel_input(t, route) for t in (q, k, v))
    q_seg, kv_seg = _segments(q_seg, kv_seg, q.device)
    B, nh, Lq, hd = q.shape
    Lk = k.shape[2]
    o = _heads_major(B, nh, Lq, hd, q)
    l = torch.empty((B, nh, Lq), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
                 l.data_ptr(), m.data_ptr(), _view(q), _view(k), _view(v), _view(o), B, nh, Lq, Lk, hd, sm_scale,
                 _DTYPES[q.dtype], _ROUTE_CODES[route], *_device_stream(q))
    _check(err, "forward", q)
    fwd_launches.add()
    fwd_route_launches[route].add()
    fwd_head_dim_launches[hd].add()
    fwd_template_launches[template_head_dim(hd)].add()
    return o, l, m


def _rows_input(t: torch.Tensor) -> torch.Tensor:
    """A (B, nh, L) fp32 row input (l, m, di, 1 / l) contiguous and 16-byte aligned."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _backward_inputs(q, k, v, q_seg, kv_seg, l, m, do, di, route):
    q, k, v, do = (_kernel_input(t, route) for t in (q, k, v, do))
    q_seg, kv_seg = _segments(q_seg, kv_seg, q.device)
    l, m, di = (_rows_input(t) for t in (l, m, di))
    return q, k, v, q_seg, kv_seg, l, m, do, di


def _launch_rows(o, do, l):
    """(di, 1 / l), (B, nh, L) fp32, on the card: di from o and do read once
    in their dtype (:func:`flash_di_card_order`'s order), 1 / l once a row."""
    launch = _fns()[3]
    o, do = _kernel_input(o), _kernel_input(do)
    l = _rows_input(l)
    B, nh, L, hd = o.shape
    di, inv_l = torch.empty_like(l), torch.empty_like(l)
    err = launch(o.data_ptr(), do.data_ptr(), l.data_ptr(), di.data_ptr(), inv_l.data_ptr(), _view(o), _view(do),
                 B, nh, L, hd, _DTYPES[o.dtype], *_device_stream(o))
    _check(err, "di", o)
    rows_launches.add()
    if o.dtype == torch.float32:
        rows_fp32_launches.add()
    return di, inv_l


def _route_inv_l(route: str, l: torch.Tensor, inv_l: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """What K12's and K13's routes "wgmma" and "tf32" read in place of l:
    ``inv_l`` (1 / l, as :func:`_launch_rows` gives it; None: ``1 / l`` here);
    None for route "simple", which reads l."""
    if route == "simple":
        return None
    return _rows_input(torch.ones_like(l) / l if inv_l is None else inv_l)


def _launch_dkv(q, k, v, q_seg, kv_seg, sm_scale: float, l, m, do, di, route: Optional[str] = None,
                inv_l: Optional[torch.Tensor] = None):
    """K12: (dk, dv), (B, nh, Lk, hd) views of (B, Lk, nh, hd) buffers.
    ``route`` as :func:`kernel_route` takes it for the backward; routes
    "wgmma" and "tf32" read 1 / l (:func:`_route_inv_l`)."""
    launch = _fns()[1]
    route = _route(q, route, backward=True)
    q, k, v, q_seg, kv_seg, l, m, do, di = _backward_inputs(q, k, v, q_seg, kv_seg, l, m, do, di, route)
    inv_l = _route_inv_l(route, l, inv_l)
    B, nh, Lq, hd = q.shape
    Lk = k.shape[2]
    dk, dv = _heads_major(B, nh, Lk, hd, k), _heads_major(B, nh, Lk, hd, v)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), l.data_ptr(),
                 None if inv_l is None else inv_l.data_ptr(), m.data_ptr(), do.data_ptr(), di.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), _view(q), _view(k), _view(v), _view(do), _view(dk), _view(dv), B, nh,
                 Lq, Lk, hd, sm_scale, _DTYPES[q.dtype], _ROUTE_CODES[route], *_device_stream(q))
    _check(err, "dK/dV", q)
    dkv_launches.add()
    dkv_route_launches[route].add()
    dkv_head_dim_launches[hd].add()
    dkv_template_launches[template_head_dim(hd)].add()
    return dk, dv


def _launch_dq(q, k, v, q_seg, kv_seg, sm_scale: float, l, m, do, di, route: Optional[str] = None,
               inv_l: Optional[torch.Tensor] = None):
    """K13: dq, a (B, nh, Lq, hd) view of a (B, Lq, nh, hd) buffer; routes
    as K12's, those but "simple" reading 1 / l (:func:`_route_inv_l`)."""
    launch = _fns()[2]
    route = _route(q, route, backward=True)
    q, k, v, q_seg, kv_seg, l, m, do, di = _backward_inputs(q, k, v, q_seg, kv_seg, l, m, do, di, route)
    inv_l = _route_inv_l(route, l, inv_l)
    B, nh, Lq, hd = q.shape
    Lk = k.shape[2]
    dq = _heads_major(B, nh, Lq, hd, q)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), l.data_ptr(),
                 None if inv_l is None else inv_l.data_ptr(), m.data_ptr(), do.data_ptr(), di.data_ptr(),
                 dq.data_ptr(), _view(q), _view(k), _view(v), _view(do), _view(dq), B, nh, Lq, Lk, hd, sm_scale,
                 _DTYPES[q.dtype], _ROUTE_CODES[route], *_device_stream(q))
    _check(err, "dQ", q)
    dq_launches.add()
    dq_route_launches[route].add()
    dq_head_dim_launches[hd].add()
    dq_template_launches[template_head_dim(hd)].add()
    return dq


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _refuse(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash attention needs q, k, v on one device, got {q.device}, {k.device}, {v.device}")
    why = kernel_refusal(q, k, v)
    if why is not None:
        raise NotImplementedError(f"flash attention kernels do not take {why} on the card "
                                  "(ROADMAP.md Queue 1 step 12)")


def flash_forward(q, k, v, q_seg, kv_seg, sm_scale: float):
    """(o, l, m): K11 for CUDA tensors, :func:`flash_forward_ref` for CPU tensors."""
    if _on_cpu(q, k, v):
        return flash_forward_ref(q, k, v, q_seg, kv_seg, sm_scale)
    _refuse(q, k, v)
    return _launch_forward(q, k, v, q_seg, kv_seg, sm_scale)


def flash_backward(q, k, v, q_seg, kv_seg, sm_scale: float, o, l, m, do):
    """(dq, dk, dv): di and 1 / l, then K12 and K13 on both, for CUDA tensors;
    :func:`flash_di` and :func:`flash_backward_ref` for CPU tensors."""
    if _on_cpu(q, k, v):
        return flash_backward_ref(q, k, v, q_seg, kv_seg, sm_scale, l, m, do, flash_di(o, do))
    _refuse(q, k, v)
    di, inv_l = _launch_rows(o, do, l)
    dk, dv = _launch_dkv(q, k, v, q_seg, kv_seg, sm_scale, l, m, do, di, inv_l=inv_l)
    return _launch_dq(q, k, v, q_seg, kv_seg, sm_scale, l, m, do, di, inv_l=inv_l), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, sm_scale):
        o, l, m = flash_forward(q, k, v, q_seg, kv_seg, sm_scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, l, m = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, q_seg, kv_seg, ctx.sm_scale, o, l, m, do)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_segment_ids: torch.Tensor,
                    kv_segment_ids: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale + segment mask) v, q (B, nh, Lq, hd), k and v
    (B, nh, Lk, hd), segment ids (B, Lq) and (B, Lk) int: the JAX
    ``flash_attention(q, k, v, segment_ids=SegmentIds(q, kv), sm_scale=...)``.
    Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, float(sm_scale))


#: launches of K11 (forward), K12 (dK/dV) and K13 (dQ)
fwd_launches = LaunchCounter()
dkv_launches = LaunchCounter()
dq_launches = LaunchCounter()
#: K11's, K12's and K13's launches by route (:data:`ROUTES`, :data:`TF32_ROUTE`)
fwd_route_launches = {r: LaunchCounter() for r in (*ROUTES, TF32_ROUTE)}
dkv_route_launches = {r: LaunchCounter() for r in (*ROUTES, TF32_ROUTE)}
dq_route_launches = {r: LaunchCounter() for r in (*ROUTES, TF32_ROUTE)}
#: K11's, K12's and K13's launches by the caller's head dim (1 .. :data:`MAX_HEAD_DIM`)
fwd_head_dim_launches = {hd: LaunchCounter() for hd in range(1, MAX_HEAD_DIM + 1)}
dkv_head_dim_launches = {hd: LaunchCounter() for hd in range(1, MAX_HEAD_DIM + 1)}
dq_head_dim_launches = {hd: LaunchCounter() for hd in range(1, MAX_HEAD_DIM + 1)}
#: K11's, K12's and K13's launches by the template they ran on (:data:`HEAD_DIMS`)
fwd_template_launches = {t: LaunchCounter() for t in HEAD_DIMS}
dkv_template_launches = {t: LaunchCounter() for t in HEAD_DIMS}
dq_template_launches = {t: LaunchCounter() for t in HEAD_DIMS}
#: launches of the backward's rows kernel (di and 1 / l), all, and those on fp32 inputs
rows_launches = LaunchCounter()
rows_fp32_launches = LaunchCounter()
