"""The routes of the port's flash kernels K11, K12 and K13 and the backward's
rows kernel (di and 1 / l) as far as the CPU can check them: the route rule,
the card path's wiring (the launches' arguments by route, with the C entry
points stood in), and the order in which the rows kernel sums di,
emulated in torch, against ``flash_di`` and the di of JAX's flash backward
(the Pallas TPU kernels run as with ``interpret=True``).  The kernels
themselves run only on the card (``tests/test_torch_kernels.py``).

Limits: the card-order di within the fp32 rounding bound of two sums of
64 products, 2 * 64 * 2^-24 * sum |o * do| a row, of ``flash_di`` and of
JAX's di; bit-equal to an independent numpy emulation of the kernel's lanes.
"""

import contextlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import config as jax_config
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from colbert_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)
# the first CPU exp after JAX can be off (tests/test_torch_flash_attention.py): made first here
torch.exp(torch.zeros(8))
torch.exp(torch.zeros(1 << 16))

SCALE = 0.125


@contextlib.contextmanager
def interpret_pallas():
    """Every ``pallas_call`` under it runs as with ``interpret=True``
    (as ``tests/test_torch_flash_attention.py`` runs the JAX kernels)."""
    prev = jax_config.pallas_tpu_interpret_mode_context_manager.swap_local(True)
    try:
        yield
    finally:
        jax_config.pallas_tpu_interpret_mode_context_manager.set_local(prev)


def _inputs(seed, L, pad, B=2, nh=2, hd=64):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(0, 1, (B, nh, L, hd)).astype(np.float32) for _ in range(4))
    seg = np.ones((B, L), np.int32)
    seg[0, pad:] = 0
    seg[1, L // 2 + 1:] = 0
    return q, k, v, w, seg


def _fp32_bound(o, do):
    x = o.float() * do.float()
    return 2 * x.shape[-1] * 2.0**-24 * x.abs().sum(-1)


def _lanes_numpy(o, do):
    """The rows kernel's order, lane by lane in numpy float32: 8 lanes a row,
    lane c summing the products of elements 8c .. 8c + 7 from 0, then
    s += shfl_xor(s, 4), 2, 1 (every lane ends with lane 0's value)."""
    x = o.float().numpy().astype(np.float32) * do.float().numpy().astype(np.float32)
    lanes = np.zeros(x.shape[:-1] + (8,), np.float32)
    for c in range(8):
        for e in range(8):
            lanes[..., c] = lanes[..., c] + x[..., 8 * c + e]
    for d in (4, 2, 1):
        lanes = lanes + lanes[..., [c ^ d for c in range(8)]]
    return torch.from_numpy(lanes[..., 0].copy())


# ---- the route rule ----

@pytest.mark.parametrize("shape,dtype", [
    ((68, 12, 384, 64), torch.bfloat16),   # the retriever's doc pass
    ((20, 16, 384, 64), torch.bfloat16),   # the CE's pairs
    ((384, 12, 384, 64), torch.bfloat16),  # the encode batch
    ((3, 2, 128, 64), torch.bfloat16),     # one JAX block: 128-row K11 blocks
    ((5, 4, 256, 64), torch.float16),
    ((2, 3, 640, 64), torch.bfloat16),     # a multiple of 128, not of 192
])
def test_every_shape_the_kernels_take_goes_to_wgmma(shape, dtype):
    """Route "wgmma" for every input the kernels take, bf16 and fp16 alike:
    the launches' default, K11's, K12's and K13's; "simple" only on request.
    What they refuse, both routes refuse: ``kernel_refusal`` runs before any
    launch (``tests/test_torch_flash_attention.py::test_kernel_refusal_rule``)."""
    q = torch.zeros(shape, dtype=dtype)
    assert fa.kernel_refusal(q, q, q) is None
    for launch in (fa._launch_forward, fa._launch_dkv, fa._launch_dq):
        assert inspect.signature(launch).parameters["route"].default == "wgmma"
    for launch in (fa._launch_dkv, fa._launch_dq):
        assert inspect.signature(launch).parameters["inv_l"].default is None
    assert fa.ROUTES == ("wgmma", "simple")
    assert set(fa.fwd_route_launches) == set(fa.dkv_route_launches) == set(fa.dq_route_launches) == set(fa.ROUTES)


def test_card_path_wires_di_and_inv_l(monkeypatch):
    """``flash_backward`` on the card path: di and 1 / l from the rows kernel
    (once), K12 and K13 on the default route (none passed), each with both;
    the launches stood in by the plain versions (the kernels run only on the
    card)."""
    q, k, v, w, seg = _inputs(5, 256, 129)
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    s = torch.from_numpy(seg)
    o, l, m = fa.flash_forward_ref(qt, kt, vt, s, s, SCALE)
    do = torch.from_numpy(w).bfloat16()
    seen = {}

    def rows(o_, do_, l_):
        seen["rows"] = seen.get("rows", 0) + 1
        return fa.flash_di_card_order(o_, do_), torch.ones_like(l_) / l_

    def dkv(q_, k_, v_, qs, ks, sc, l_, m_, do_, di, route=None, inv_l=None):
        seen["dkv"] = (route, di, inv_l)
        return fa.flash_backward_ref(q_, k_, v_, qs, ks, sc, l_, m_, do_, di)[1:]

    def dq(q_, k_, v_, qs, ks, sc, l_, m_, do_, di, route=None, inv_l=None):
        seen["dq"] = (route, di, inv_l)
        return fa.flash_backward_ref(q_, k_, v_, qs, ks, sc, l_, m_, do_, di)[0]

    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_refuse", lambda *ts: None)
    monkeypatch.setattr(fa, "_launch_rows", rows)
    monkeypatch.setattr(fa, "_launch_dkv", dkv)
    monkeypatch.setattr(fa, "_launch_dq", dq)
    got = fa.flash_backward(qt, kt, vt, s, s, SCALE, o, l, m, do)
    di = fa.flash_di_card_order(o, do)
    route, di_dkv, inv_l = seen["dkv"]
    route_dq, di_dq, inv_l_dq = seen["dq"]
    assert seen["rows"] == 1 and route is None and route_dq is None
    assert torch.equal(di_dkv, di) and torch.equal(di_dq, di)
    assert torch.equal(inv_l, torch.ones_like(l) / l) and inv_l_dq is inv_l  # the rows kernel's one 1 / l
    want = fa.flash_backward_ref(qt, kt, vt, s, s, SCALE, l, m, do, di)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("route", ["wgmma", "simple"])
@pytest.mark.parametrize("given_inv_l", [True, False])
def test_dq_launch_arguments_by_route(monkeypatch, route, given_inv_l):
    """``_launch_dq`` hands the C entry point what K13's route reads, as
    ``_launch_dkv`` hands K12's: route code 1 with 1 / l (the caller's, or
    ``1 / l`` computed when none is given) and route code 0 with l and a null
    1 / l; q's (batch, head, row) strides in the models' layout; dq a
    heads-major view; one launch counted in all and one by route.  The C
    entry point is stood in (it exists only where nvcc built it)."""
    B, nh, L = 2, 3, 256
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((B, L, nh, 64), generator=g).bfloat16().transpose(1, 2) for _ in range(4))
    seg = torch.ones((B, L), dtype=torch.int32)
    l = torch.rand((B, nh, L), generator=g) + 1
    m, di = torch.randn((B, nh, L), generator=g), torch.randn((B, nh, L), generator=g)
    inv_l = torch.ones_like(l) / l
    got = {}

    def launch(*a):
        got["args"] = a
        return 0

    monkeypatch.setattr(fa, "_fns", lambda: (None, None, launch, None))
    monkeypatch.setattr(fa, "_device_stream", lambda t: (0, 0))
    before = (fa.dq_launches.value, {r: c.value for r, c in fa.dq_route_launches.items()})
    dq = fa._launch_dq(q, k, v, seg, seg, SCALE, l, m, do, di, route=route,
                       inv_l=inv_l if given_inv_l else None)
    a = got["args"]
    assert len(a) == 25 and a[21] == 0 and a[22] == {"simple": 0, "wgmma": 1}[route]
    assert a[5] == l.data_ptr() and a[7] == m.data_ptr() and a[9] == di.data_ptr() and a[10] == dq.data_ptr()
    if route == "simple":
        assert a[6] is None
    elif given_inv_l:
        assert a[6] == inv_l.data_ptr()
    else:
        assert a[6] not in (None, l.data_ptr(), inv_l.data_ptr())
    assert list(a[11]) == [L * nh * 64, 64, nh * 64] and list(a[15]) == list(a[11])  # q's and dq's strides
    assert a[16:20] == (B, nh, L, L) and a[20] == SCALE
    assert dq.shape == q.shape and dq.transpose(1, 2).is_contiguous()
    assert fa.dq_launches.value == before[0] + 1
    assert {r: c.value - before[1][r] for r, c in fa.dq_route_launches.items()} == {
        r: int(r == route) for r in fa.ROUTES}


def test_cpu_path_keeps_flash_di():
    """On CPU tensors the backward is the plain one on ``flash_di``; no
    kernel, rows or route launch is counted."""
    q, k, v, w, seg = _inputs(6, 128, 100)
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    s = torch.from_numpy(seg)
    o, l, m = fa.flash_forward_ref(qt, kt, vt, s, s, SCALE)
    do = torch.from_numpy(w).bfloat16()
    counters = [fa.rows_launches, *fa.fwd_route_launches.values(), *fa.dkv_route_launches.values(),
                *fa.dq_route_launches.values()]
    before = [c.value for c in counters]
    got = fa.flash_backward(qt, kt, vt, s, s, SCALE, o, l, m, do)
    want = fa.flash_backward_ref(qt, kt, vt, s, s, SCALE, l, m, do, fa.flash_di(o, do))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c.value for c in counters] == before


# ---- the rows kernel's di order ----

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_card_order_is_the_kernels_lanes(dtype):
    """``flash_di_card_order`` is bit-equal to the kernel's lanes emulated one by one."""
    rng = np.random.default_rng(7)
    o, do = (torch.from_numpy(rng.normal(0, 3, (3, 2, 128, 64)).astype(np.float32)).to(getattr(torch, dtype))
             for _ in range(2))
    assert torch.equal(fa.flash_di_card_order(o, do), _lanes_numpy(o, do))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("L,pad", [(128, 100), (384, 200)])
def test_card_order_di_matches_flash_di_and_jax(L, pad, dtype):
    """The card's order against ``flash_di`` and against JAX's backward di
    (``jnp.sum(o * do)`` over the head dim in fp32, on the interpreted JAX
    forward's o), each within fp32 rounding."""
    q, k, v, w, seg = _inputs(11 * L + pad, L, pad)
    jd = jnp.dtype(dtype)
    with interpret_pallas():
        o = jax_flash(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                      segment_ids=SegmentIds(jnp.asarray(seg), jnp.asarray(seg)), sm_scale=SCALE)
    do_j = jnp.asarray(w).astype(jd)
    di_jax = torch.from_numpy(np.array(jnp.sum(o.astype(jnp.float32) * do_j.astype(jnp.float32), axis=-1)))
    ot = torch.from_numpy(np.array(o.astype(jnp.float32))).to(getattr(torch, dtype))
    dot = torch.from_numpy(np.array(do_j.astype(jnp.float32))).to(getattr(torch, dtype))
    got = fa.flash_di_card_order(ot, dot)
    bound = _fp32_bound(ot, dot)
    assert got.dtype == torch.float32 and got.shape == (2, 2, L)
    assert bool(((got - fa.flash_di(ot, dot)).abs() <= bound).all())
    assert bool(((got - di_jax).abs() <= bound).all())
