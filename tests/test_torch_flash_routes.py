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
import types

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
    """The rows kernel's order, lane by lane in numpy float32: hd / 8 lanes a
    row, lane c summing the products of elements 8c .. 8c + 7 from 0, then
    s += shfl_xor(s, hd / 16), ..., 2, 1 (every lane ends with lane 0's value)."""
    x = o.float().numpy().astype(np.float32) * do.float().numpy().astype(np.float32)
    n = x.shape[-1] // 8
    lanes = np.zeros(x.shape[:-1] + (n,), np.float32)
    for c in range(n):
        for e in range(8):
            lanes[..., c] = lanes[..., c] + x[..., 8 * c + e]
    d = n // 2
    while d >= 1:
        lanes = lanes + lanes[..., [c ^ d for c in range(n)]]
        d //= 2
    return torch.from_numpy(lanes[..., 0].copy())


# ---- the route rule ----

@pytest.mark.parametrize("shape,dtype", [
    ((68, 12, 384, 64), torch.bfloat16),   # the retriever's doc pass
    ((20, 16, 384, 64), torch.bfloat16),   # the CE's pairs
    ((384, 12, 384, 64), torch.bfloat16),  # the encode batch
    ((3, 2, 128, 64), torch.bfloat16),     # one JAX block: 128-row K11 blocks
    ((5, 4, 256, 64), torch.float16),
    ((2, 3, 640, 64), torch.bfloat16),     # a multiple of 128, not of 192
    ((68, 12, 384, 32), torch.bfloat16),   # the MiniLM-L12-H384-width retriever's doc pass
    ((3, 4, 256, 32), torch.float16),
    ((68, 8, 384, 128), torch.bfloat16),   # head dim 128
    ((2, 2, 128, 128), torch.float16),
])
def test_every_shape_the_kernels_take_goes_to_wgmma(shape, dtype):
    """Route "wgmma" for every input the kernels take, bf16 and fp16 alike:
    the launches' default (no route given), K11's, K12's and K13's; "simple"
    only on request; route "tf32" (K11, K12, K13) for fp32 inputs alone,
    and no other route for them.  What they refuse, every route refuses:
    ``kernel_refusal`` runs before any launch
    (``tests/test_torch_flash_attention.py::test_kernel_refusal_rule``)."""
    q = torch.zeros(shape, dtype=dtype)
    assert fa.kernel_refusal(q, q, q) is None
    for launch in (fa._launch_forward, fa._launch_dkv, fa._launch_dq):
        assert inspect.signature(launch).parameters["route"].default is None
    for launch in (fa._launch_dkv, fa._launch_dq):
        assert inspect.signature(launch).parameters["inv_l"].default is None
    for backward in (False, True):
        assert fa.kernel_route(dtype, backward=backward) == "wgmma"
        assert fa.kernel_route(dtype, "simple", backward=backward) == "simple"
    assert fa.kernel_route(torch.float32) == fa.kernel_route(torch.float32, "tf32") == "tf32"
    for bad_dtype, bad_route in ((dtype, "fp32"), (dtype, "tf32"), (torch.float32, "wgmma"),
                                 (torch.float32, "simple"), (torch.float32, "fp32")):
        with pytest.raises(ValueError, match="route"):
            fa.kernel_route(bad_dtype, bad_route)
    assert fa.ROUTES == ("wgmma", "simple") and fa.TF32_ROUTE == "tf32" and not hasattr(fa, "FP32_ROUTE")
    assert set(fa.fwd_route_launches) == {*fa.ROUTES, fa.TF32_ROUTE}
    assert set(fa.dkv_route_launches) == set(fa.dq_route_launches) == {*fa.ROUTES, fa.TF32_ROUTE}


@pytest.mark.parametrize("dtype,route,backward,want", [
    (torch.float32, None, True, "tf32"),     # the fp32 backward: "tf32" only
    (torch.float32, "tf32", True, "tf32"),
    (torch.float32, "fp32", True, None),
    (torch.float32, None, False, "tf32"),    # the fp32 forward: "tf32" only
    (torch.float32, "fp32", False, None),    # "fp32" is no kernel's route
    (torch.float32, "tf32", False, "tf32"),
    (torch.float32, "wgmma", True, None),
    (torch.float32, "simple", True, None),
    (torch.bfloat16, "tf32", True, None),    # bf16 and fp16 never take "tf32" or "fp32"
    (torch.float16, "tf32", True, None),
    (torch.bfloat16, "fp32", True, None),
    (torch.float16, None, True, "wgmma"),
])
def test_fp32_backward_route_rule(dtype, route, backward, want):
    """K11, K12 and K13 (``backward`` either way) give fp32 inputs route
    "tf32" only; bf16 and fp16 never take it; any other pairing, route
    "fp32" among them, raises ValueError, before any launch."""
    if want is None:
        with pytest.raises(ValueError, match="route"):
            fa.kernel_route(dtype, route, backward=backward)
    else:
        assert fa.kernel_route(dtype, route, backward=backward) == want


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


@pytest.mark.parametrize("route", ["wgmma", "simple", "tf32"])
@pytest.mark.parametrize("given_inv_l", [True, False])
def test_dq_launch_arguments_by_route(monkeypatch, route, given_inv_l):
    """``_launch_dq`` hands the C entry point what K13's route reads, as
    ``_launch_dkv`` hands K12's: route codes 1 ("wgmma", bf16) and 3
    ("tf32", fp32 inputs, dtype code 2) with 1 / l (the caller's, or ``1 /
    l`` computed when none is given) and route code 0 with l and a null 1 /
    l;
    q's (batch, head, row) strides in the models' layout; dq a heads-major
    view; one launch counted in all and one by route.  The C entry point is
    stood in (it exists only where nvcc built it)."""
    B, nh, L = 2, 3, 256
    g = torch.Generator().manual_seed(3)
    dtype = torch.float32 if route == "tf32" else torch.bfloat16
    q, k, v, do = (torch.randn((B, L, nh, 64), generator=g).to(dtype).transpose(1, 2) for _ in range(4))
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
    codes = {"simple": 0, "wgmma": 1, "tf32": 3}
    assert len(a) == 26 and a[22] == int(dtype == torch.float32) * 2 and a[23] == codes[route]
    assert a[5] == l.data_ptr() and a[7] == m.data_ptr() and a[9] == di.data_ptr() and a[10] == dq.data_ptr()
    if route == "simple":
        assert a[6] is None
    elif given_inv_l:
        assert a[6] == inv_l.data_ptr()
    else:
        assert a[6] not in (None, l.data_ptr(), inv_l.data_ptr())
    assert list(a[11]) == [L * nh * 64, 64, nh * 64] and list(a[15]) == list(a[11])  # q's and dq's strides
    assert a[16:21] == (B, nh, L, L, 64) and a[21] == SCALE
    assert dq.shape == q.shape and dq.transpose(1, 2).is_contiguous()
    assert fa.dq_launches.value == before[0] + 1
    assert {r: c.value - before[1][r] for r, c in fa.dq_route_launches.items()} == {
        r: int(r == route) for r in (*fa.ROUTES, fa.TF32_ROUTE)}


@pytest.mark.parametrize("route,want_code", [(None, 3), ("tf32", 3), ("fp32", None)])
def test_fp32_dkv_launch_arguments_by_route(monkeypatch, route, want_code):
    """``_launch_dkv`` on fp32 inputs: route code 3 ("tf32", also when none
    is given), dtype code 2, the rows kernel's 1 / l passed on; dk and dv
    heads-major views; one launch counted in all and one on "tf32".  Route
    "fp32" (no kernel's route: the rows kernel's alone) raises ValueError
    before any launch or count.  The C entry point is stood in."""
    B, nh, L = 2, 3, 256
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn((B, L, nh, 64), generator=g).transpose(1, 2) for _ in range(4))
    seg = torch.ones((B, L), dtype=torch.int32)
    l = torch.rand((B, nh, L), generator=g) + 1
    m, di = torch.randn((B, nh, L), generator=g), torch.randn((B, nh, L), generator=g)
    inv_l = torch.ones_like(l) / l
    got = {}

    def launch(*a):
        got["args"] = a
        return 0

    monkeypatch.setattr(fa, "_fns", lambda: (None, launch, None, None))
    monkeypatch.setattr(fa, "_device_stream", lambda t: (0, 0))
    before = (fa.dkv_launches.value, {r: c.value for r, c in fa.dkv_route_launches.items()})
    if want_code is None:
        with pytest.raises(ValueError, match="route"):
            fa._launch_dkv(q, k, v, seg, seg, SCALE, l, m, do, di, route=route, inv_l=inv_l)
        assert not got and fa.dkv_launches.value == before[0]
        assert {r: c.value for r, c in fa.dkv_route_launches.items()} == before[1]
        return
    dk, dv = fa._launch_dkv(q, k, v, seg, seg, SCALE, l, m, do, di, route=route, inv_l=inv_l)
    a = got["args"]
    assert len(a) == 28 and a[18:24] == (B, nh, L, L, 64, SCALE) and a[24] == 2 and a[25] == want_code
    assert a[5] == l.data_ptr() and a[6] == inv_l.data_ptr() and a[10] == dk.data_ptr() and a[11] == dv.data_ptr()
    assert dk.shape == dv.shape == k.shape and dk.transpose(1, 2).is_contiguous() and dv.transpose(1, 2).is_contiguous()
    assert fa.dkv_launches.value == before[0] + 1
    assert {r: c.value - before[1][r] for r, c in fa.dkv_route_launches.items()} == {
        r: int(r == "tf32") for r in fa.dkv_route_launches}


@pytest.mark.parametrize("route,want_code", [(None, 3), ("tf32", 3), ("fp32", None)])
def test_fp32_forward_launch_arguments_by_route(monkeypatch, route, want_code):
    """``_launch_forward`` on fp32 inputs: route code 3 ("tf32", also when
    none is given), dtype code 2; o a heads-major view, l and m (B, nh, L)
    fp32; one launch counted in all and one on "tf32".  Route "fp32" raises
    ValueError before any launch or count.  The C entry point is stood in."""
    B, nh, L = 2, 3, 256
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((B, L, nh, 64), generator=g).transpose(1, 2) for _ in range(3))
    seg = torch.ones((B, L), dtype=torch.int32)
    got = {}

    def launch(*a):
        got["args"] = a
        return 0

    monkeypatch.setattr(fa, "_fns", lambda: (launch, None, None, None))
    monkeypatch.setattr(fa, "_device_stream", lambda t: (0, 0))
    before = (fa.fwd_launches.value, {r: c.value for r, c in fa.fwd_route_launches.items()})
    if want_code is None:
        with pytest.raises(ValueError, match="route"):
            fa._launch_forward(q, k, v, seg, seg, SCALE, route=route)
        assert not got and fa.fwd_launches.value == before[0]
        assert {r: c.value for r, c in fa.fwd_route_launches.items()} == before[1]
        return
    o, l, m = fa._launch_forward(q, k, v, seg, seg, SCALE, route=route)
    a = got["args"]
    assert len(a) == 22 and a[12:18] == (B, nh, L, L, 64, SCALE) and a[18] == 2 and a[19] == want_code
    assert a[3] == o.data_ptr() and a[6] == l.data_ptr() and a[7] == m.data_ptr()
    assert list(a[8]) == [L * nh * 64, 64, nh * 64] and list(a[11]) == list(a[8])  # q's and o's strides
    assert o.shape == q.shape and o.dtype == torch.float32 and o.transpose(1, 2).is_contiguous()
    assert l.shape == m.shape == (B, nh, L) and l.dtype == m.dtype == torch.float32
    assert fa.fwd_launches.value == before[0] + 1
    assert {r: c.value - before[1][r] for r, c in fa.fwd_route_launches.items()} == {
        r: int(r == "tf32") for r in fa.fwd_route_launches}


@pytest.mark.parametrize("hd", [32, 128, 26, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launches_pass_the_head_dim(monkeypatch, dtype, hd):
    """At head dims 32, 128, 26 and 80 each launch hands its C entry point the
    head dim (after the lengths) and q itself, no copy, with its strides in
    the models' layout, on the default route ("wgmma" for bf16, "tf32" for
    fp32); the rows kernel too; each launch is counted at the head dim and
    at the template it runs on.  The C entry points are stood in."""
    B, nh, L = 2, 3, 256
    g = torch.Generator().manual_seed(hd)
    q, k, v, do = (torch.randn((B, L, nh, hd), generator=g).to(dtype).transpose(1, 2) for _ in range(4))
    seg = torch.ones((B, L), dtype=torch.int32)
    l = torch.rand((B, nh, L), generator=g) + 1
    m, di = torch.randn((B, nh, L), generator=g), torch.randn((B, nh, L), generator=g)
    got = {}

    def stand_in(name):
        def launch(*a):
            got[name] = a
            return 0
        return launch

    monkeypatch.setattr(fa, "_fns", lambda: tuple(stand_in(n) for n in ("fwd", "dkv", "dq", "rows")))
    monkeypatch.setattr(fa, "_device_stream", lambda t: (0, 0))
    code = 3 if dtype == torch.float32 else 1
    counted = [c[key] for c, key in ((fa.fwd_head_dim_launches, hd), (fa.dkv_head_dim_launches, hd),
                                     (fa.dq_head_dim_launches, hd),
                                     (fa.fwd_template_launches, fa.template_head_dim(hd)),
                                     (fa.dkv_template_launches, fa.template_head_dim(hd)),
                                     (fa.dq_template_launches, fa.template_head_dim(hd)))]
    before = [c.value for c in counted]
    fa._launch_forward(q, k, v, seg, seg, SCALE)
    fa._launch_dkv(q, k, v, seg, seg, SCALE, l, m, do, di)
    fa._launch_dq(q, k, v, seg, seg, SCALE, l, m, do, di)
    fa._launch_rows(q, do, l)
    assert [c.value - b for c, b in zip(counted, before)] == [1] * 6
    assert got["fwd"][:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert got["dkv"][8] == got["dq"][8] == do.data_ptr()
    assert got["fwd"][12:19] == (B, nh, L, L, hd, SCALE, int(dtype == torch.float32) * 2) and got["fwd"][19] == code
    assert got["dkv"][18:24] == (B, nh, L, L, hd, SCALE) and got["dkv"][25] == code
    assert got["dq"][16:22] == (B, nh, L, L, hd, SCALE) and got["dq"][23] == code
    assert got["rows"][7:11] == (B, nh, L, hd)
    assert list(got["fwd"][8]) == [L * nh * hd, hd, nh * hd]


@pytest.mark.parametrize("hd", [32, 128])
def test_simple_route_takes_head_dim_64_only(monkeypatch, hd):
    """Route "simple" (the first design) stays at head dim 64: at 32 and 128
    each of its launches raises NotImplementedError naming the route, before
    the C entry point or any count."""
    B, nh, L = 2, 2, 128
    q = torch.zeros((B, nh, L, hd), dtype=torch.bfloat16)
    seg = torch.ones((B, L), dtype=torch.int32)
    rows = torch.ones((B, nh, L))
    called = []
    monkeypatch.setattr(fa, "_fns", lambda: tuple(lambda *a: called.append(a) or 0 for _ in range(4)))
    monkeypatch.setattr(fa, "_device_stream", lambda t: (0, 0))
    counters = [fa.fwd_launches, fa.dkv_launches, fa.dq_launches, *fa.fwd_route_launches.values()]
    before = [c.value for c in counters]
    with pytest.raises(NotImplementedError, match="route 'simple'"):
        fa._launch_forward(q, q, q, seg, seg, SCALE, route="simple")
    for launch in (fa._launch_dkv, fa._launch_dq):
        with pytest.raises(NotImplementedError, match="route 'simple'"):
            launch(q, q, q, seg, seg, SCALE, rows, rows, q, rows, route="simple")
    assert not called and [c.value for c in counters] == before


@pytest.mark.parametrize("given_inv_l", [True, False])
def test_fp32_dq_refuses_the_forward_route(monkeypatch, given_inv_l):
    """``_launch_dq`` on fp32 inputs with route "fp32" (no kernel's route)
    raises ValueError before it reaches the C entry point or counts a
    launch, whether or not 1 / l is given: K13 takes fp32 on route "tf32"
    only."""
    B, nh, L = 2, 3, 256
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn((B, L, nh, 64), generator=g).transpose(1, 2) for _ in range(4))
    seg = torch.ones((B, L), dtype=torch.int32)
    l = torch.rand((B, nh, L), generator=g) + 1
    m, di = torch.randn((B, nh, L), generator=g), torch.randn((B, nh, L), generator=g)
    called = []
    monkeypatch.setattr(fa, "_fns", lambda: (None, None, lambda *a: called.append(a) or 0, None))
    monkeypatch.setattr(fa, "_device_stream", lambda t: (0, 0))
    before = (fa.dq_launches.value, {r: c.value for r, c in fa.dq_route_launches.items()})
    with pytest.raises(ValueError, match="route"):
        fa._launch_dq(q, k, v, seg, seg, SCALE, l, m, do, di, route="fp32",
                      inv_l=torch.ones_like(l) / l if given_inv_l else None)
    assert not called and fa.dq_launches.value == before[0]
    assert {r: c.value for r, c in fa.dq_route_launches.items()} == before[1]


def test_cpu_path_keeps_flash_di():
    """On CPU tensors the backward is the plain one on ``flash_di``; no
    kernel, rows or route launch is counted."""
    q, k, v, w, seg = _inputs(6, 128, 100)
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    s = torch.from_numpy(seg)
    o, l, m = fa.flash_forward_ref(qt, kt, vt, s, s, SCALE)
    do = torch.from_numpy(w).bfloat16()
    counters = [fa.rows_launches, fa.rows_fp32_launches, *fa.fwd_route_launches.values(),
                *fa.dkv_route_launches.values(), *fa.dq_route_launches.values()]
    before = [c.value for c in counters]
    got = fa.flash_backward(qt, kt, vt, s, s, SCALE, o, l, m, do)
    want = fa.flash_backward_ref(qt, kt, vt, s, s, SCALE, l, m, do, fa.flash_di(o, do))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c.value for c in counters] == before


# ---- the rows kernel's di order ----

@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_card_order_is_the_kernels_lanes(dtype, hd):
    """``flash_di_card_order`` is bit-equal to the kernel's lanes emulated one
    by one, at each head dim the kernels take (hd / 8 lanes a row)."""
    rng = np.random.default_rng(7 + hd)
    o, do = (torch.from_numpy(rng.normal(0, 3, (3, 2, 128, hd)).astype(np.float32)).to(getattr(torch, dtype))
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


@pytest.mark.parametrize("hd", [26, 25, 8, 100, 127])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_card_order_below_a_template_is_the_padded_lanes(dtype, hd):
    """Below a template the rows kernel's lanes cover the template's columns,
    those past the head dim zeros: ``flash_di_card_order`` at hd is the
    lanes' order on o and do padded with zeros to the template (the padding
    lives in this check alone)."""
    rng = np.random.default_rng(11 + hd)
    o, do = (torch.from_numpy(rng.normal(0, 3, (2, 3, 128, hd)).astype(np.float32)).to(getattr(torch, dtype))
             for _ in range(2))
    t = fa.template_head_dim(hd)
    pad = lambda x: torch.nn.functional.pad(x, (0, t - hd))
    assert torch.equal(fa.flash_di_card_order(o, do), _lanes_numpy(pad(o), pad(do)))
    assert bool(((fa.flash_di_card_order(o, do) - fa.flash_di(o, do)).abs() <= _fp32_bound(o, do)).all())


def test_template_rule_and_the_libraries_handshake():
    """Head dims 1-32 run on the 32 template, 33-64 on 64, 65-128 on 128;
    0, 129, 130, 192 and 256 on none.  ``bind`` takes a library whose
    ``flash_head_dim_template`` gives the same rule and refuses one that
    differs at any head dim (here 26 on the 64 template)."""
    assert [fa.template_head_dim(hd) for hd in (1, 26, 32, 33, 64, 65, 80, 96, 127, 128)] == [
        32, 32, 32, 64, 64, 128, 128, 128, 128, 128]
    assert all(fa.template_head_dim(hd) is None for hd in (0, 129, 130, 192, 256))

    def lib(rule):
        entries = ("flash_fwd_launch", "flash_bwd_dkv_launch", "flash_bwd_dq_launch", "flash_bwd_rows_launch")
        return types.SimpleNamespace(flash_head_dim_template=lambda hd: rule(hd),
                                     **{name: (lambda *a: 0) for name in entries})

    fa.bind(lib(lambda hd: fa.template_head_dim(hd) or 0))
    with pytest.raises(RuntimeError, match="26"):
        fa.bind(lib(lambda hd: 64 if hd == 26 else fa.template_head_dim(hd) or 0))
