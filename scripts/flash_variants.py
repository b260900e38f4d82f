#!/usr/bin/env python3
"""The flash-attention kernels K11-K13 and the backward's rows kernel on one
NVIDIA GPU, alone: ``chip_smoke.py``'s phase 8a without the rest of the script.

    python3 scripts/flash_variants.py            # phase 8a: checks at five shapes, times at three
    python3 scripts/flash_variants.py --quick    # the checks alone, no times
    python3 scripts/flash_variants.py --blocks   # then K11 with 192-row blocks against 128-row blocks
    python3 scripts/flash_variants.py --variant expf   # then phase 8a on a variant of the source
    python3 scripts/flash_variants.py --quick --probe k12_no_elementwise   # then times alone, no checks
    python3 scripts/flash_variants.py --quick --probe dq_stages4   # K13's ring
    python3 scripts/flash_variants.py --quick --probe tf32_expf   # route "tf32" (fp32 K11, K12, K13)
    python3 scripts/flash_variants.py --quick --stress 50   # the wrapper's path 50 times over garbage, bit-equal?
    python3 scripts/flash_variants.py --quick --train 4     # phase 8b, then phase 8e 4 times
    python3 scripts/flash_variants.py --quick --embedding 20 --trace 6 --lookup   # the embeddings' backward

First the build of ``csrc/flash_attention.cu``: ptxas's registers, shared
memory, spills and any warning for each kernel (a wgmma that ptxas
serialises says so here), and from ``cuobjdump -sass`` of the built library
the count of each kernel's wgmma instructions (HGMMA) and warpgroup
barriers (WARPGROUP.ARRIVE / WARPGROUP.DEPBAR); the check, printed and in
the exit code: no kernel of route "wgmma" spills and ptxas serialises no
wgmma.  Then phase 8a
(``chip_smoke.flash_case`` at the retriever's, the CE's and the encode
batch's shapes, one with no padding and one padded just past 128): the
public wrapper's forward and backward and the autograd function against the
plain versions, K11, K12 and K13 on each route ("wgmma" and "simple")
against them, each twice bit-equal, the card's di against ``flash_di``; with times
(without ``--quick``) each route cold and hot beside its bound, the rows
kernel beside ``flash_di``, SDPA's forward, forward + backward and backward
alone, and the autograd function on each route.  With ``--blocks``, K11's
route "wgmma" with its blocks of 192 query rows (where they tile the
length) against the variant ``rows128``, cold, in turns (192, 128, 128,
192), at the three timed shapes.  The variants (:data:`VARIANTS`) are the
kernel's source with lines swapped, built with nvcc into
``.runs/flash_variants/``.  With ``--variant NAME``, one run through phase
8a again: its errors against the plain versions at the five shapes and its
times at three (``expf``: the "wgmma" routes' softmax exponential by
``expf`` in place of ``ex2.approx`` of x * log2(e)).  With ``--probe
NAME``, a variant's K11, K12 and K13 (route "wgmma") timed alone at the
retriever's shape, cold, in turns with the source as it is, and not
checked: the ``k12_no_*`` variants take from K12 its elementwise work, its
products, its dK/dV stores or its row inputs' loads, giving wrong numbers
by design to split its time; ``stages4`` halves K12's ring and
``dq_stages4`` K13's (8 64-key tiles).  The ``tf32_*`` variants are of
route "tf32" (K11, K12 and K13 on fp32 inputs), probed on fp32 inputs with
their outputs held to the source's (``tf32_expf``: the exponential by
expf; ``tf32_no_nan_clamp``: the split without its NaN clamp;
``tf32_no_products`` and ``tf32_products_only`` take the products away or
keep them alone, wrong numbers by design).  With
``--stress N``, the wrapper's forward and backward (K11, the rows kernel,
K12, K13) at the retriever's and the CE's shapes N times, each after the
allocator's blocks were filled with NaN, every output held bit-equal to the
first run's.  With ``--train N``, ``chip_smoke.py``'s phase 8b (``train``
with flash) once and its phase 8e (3 steps under each remat policy, held
bit-equal to 8b's) N times, each failure printed.  With ``--trace N``, two
flash train steps N times, each flash launch and each gradient of the first
step digested: the first launch and the gradients that differ from the
first repeat's.  With ``--embedding N``, the embeddings' backward alone:
one flash train step records, for each pass (queries, docs), the ids and
the gradient reaching the sum of the three lookups, which is then replayed
N times for each table (word ids, token types; and the doc pass's
gradient over ids of a 128-word vocabulary) in each way of
:func:`embedding_ways`, each run's bits against the first's, with its
time (the model's ``lookup_backward``, ``F.embedding``'s own backward and
the same under deterministic algorithms among them; each as issued, on the
card alone and on the host clock); then ``F.embedding``'s
backward by table size, and one whole step under
``torch.use_deterministic_algorithms(True, warn_only=True)``, with the ops
it warns of.  ``--lookup`` puts ``F.embedding`` back into the model for the
word ids and token types, in place of ``models/bert.py``'s ``lookup``
(whose backward is ``lookup_backward``: a fixed order, no atomics), for ``--trace`` and
``--train``; ``--deterministic`` runs ``--trace`` under
``torch.use_deterministic_algorithms(True, warn_only=True)``.  Prints the
card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import contextlib
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root on the path first)


def sass_counts(so_path) -> dict:
    """For each flash kernel in the library: its HGMMA and warpgroup-barrier
    instructions, and for a kernel with HGMMAs the opcodes of its hot loop
    (the backward branch's range holding the most HGMMAs: the consumers'
    loop over tiles), counted once."""
    from colbert_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so_path)], capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name = func.split("\n", 1)[0].strip()
        insts = [(int(a, 16), op, args) for a, op, args in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)([^;]*);", func)]
        ops = Counter(op for _, op, _ in insts)
        c = {"HGMMA": sum(n for o, n in ops.items() if o.startswith("HGMMA")),
             "WARPGROUP": sum(n for o, n in ops.items() if o.startswith("WARPGROUP")), "instructions": len(insts)}
        loops = []
        for addr, op, args in insts:
            target = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) <= addr:
                body = [o for a, o, _ in insts if int(target.group(1), 16) <= a <= addr and o != "NOP"]
                loops.append((sum(o.startswith("HGMMA") for o in body), -len(body), body))
        if c["HGMMA"] and loops and max(loops)[0]:
            body = max(loops)[2]
            c["loop"] = {"instructions": len(body), "opcodes": dict(Counter(o.split(".")[0] for o in body).most_common())}
        counts[name] = c
    return counts


EX2 = """  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
"""
K12_STORES = """      store_rows_staged<T, HD, COPIES>(dK + b * vdk.sb + h * vdk.sh + (long long)key0 * vdk.sl, vdk.sl, dk, own,
                                       lane, hs.d);
      store_rows_staged<T, HD, COPIES>(dV + b * vdv.sb + h * vdv.sh + (long long)key0 * vdv.sl, vdv.sl, dv, own,
                                       lane, hs.d);
"""
K12_ROW_LOADS = """          bulk_load(rt, m_in + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + QT * 4, inv_l + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + 2 * QT * 4, di_in + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + 3 * QT * 4, qseg + (long long)b * Lq + qt * QT, QT * 4, &full[stage]);
"""
# route "tf32"'s lines that its variants change
TF32_EXP_K12 = "s[j][e] = __fmul_rn(wg::exp_p(x - (odd ? mm.y : mm.x)), odd ? il.y : il.x);"
TF32_EXP_K13 = "s[j][e] = __fmul_rn(wg::exp_p(x - m_row[r]), il[r]);"
TF32_SPLIT_K12 = "split_tiles(base + (sst - skv) + stage * C::STAGE, C::HI, C::HI, si);"
TF32_SPLIT_K13 = "split_tiles(base + (sst - sq) + stage * C::STAGE, C::HI, C::HI, si);"
TF32_SPLIT_K11 = ("          split_t<KEYS, HD>(stp + C::V_RAW, stp + C::VT_HI, stp + C::VT_LO, si);\n"
                  "          split_tiles(stp, C::KV_TILE, C::K_LO, si);  // K, then the fence for both\n")
TF32_EXP_K11 = "s[j][e] = wg::exp_p(s[j][e] - m_next[e >> 1]);"
TF32_P_SPLIT_K11 = """        split(s[kk][0], ph[kk][0], pl[kk][0]);
        split(s[kk][2], ph[kk][1], pl[kk][1]);
        split(s[kk][1], ph[kk][2], pl[kk][2]);
        split(s[kk][3], ph[kk][3], pl[kk][3]);
"""

TF32_COLS_LOADS = ("      hi[kk][r] = *reinterpret_cast<const uint32_t*>(tile_hi + off[r] + kk * 8 * 128);\n"
                   "      lo[kk][r] = *reinterpret_cast<const uint32_t*>(tile_lo + off[r] + kk * 8 * 128);")
TF32_B_STORES = ("      *reinterpret_cast<uint32_t*>(tile_hi + off) = hi;\n"
                 "      *reinterpret_cast<uint32_t*>(tile_lo + off) = lo;")
TF32_TO_THREAD = "reinterpret_cast<float4*>(buf)[j * 128 + wtid] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);"
TF32_LO = "  lo = to_tf32(__int_as_float(min(__float_as_int(__fsub_rn(x, __uint_as_float(hi))), 0x7FFFEFFF)));"
TF32_P_READS = ("const float4 p = reinterpret_cast<const float4*>(pbuf)[j * 128 + wtid];",
                "const float4 p = reinterpret_cast<const float4*>(pex)[j * 128 + wtid];")
#: name: (what it changes, [(a line of csrc/flash_attention.cu, found once, and what replaces it)])
VARIANTS = {
    "rows128": ("K11 in 128-row blocks at every length",
                [("if (Lq % wg::Fwd<D, 3>::ROWS_BLK == 0)", "if (false)")]),
    "expf": ("the \"wgmma\" routes' exponential by expf", [(EX2, "  return expf(x);\n")]),
    "stages4": ("K12's ring 4 tiles deep (head dims 32 and 64)",
                [("static constexpr int STAGES = HD == 128 ? 6 : 8;     // Q/dO tiles in flight",
                  "static constexpr int STAGES = HD == 128 ? 6 : 4;     // Q/dO tiles in flight")]),
    "k12_no_elementwise": ("K12 without its elementwise work (wrong dK/dV)",
                           [("j < QT / 8; ++j) {\n          const int qi", "j < 0; ++j) {\n          const int qi"),
                            ("j < QT / 8; ++j) {\n          const float2 dd", "j < 0; ++j) {\n          const float2 dd")]),
    "k12_no_products": ("K12 without its products (wrong dK/dV)",
                        [(f"kk < {n}; ++kk) wgmma_rs<T, {w}>({a}", f"kk < 0; ++kk) wgmma_rs<T, {w}>({a}")
                         for n, w, a in (("HD / 16", "QT, 0", "p,"), ("HD / 16", "QT, 0", "ds,"))]
                        + [(f"kk < QT / 16; ++kk)\n            wgmma_rs<T, NA, 1>(cols<NA / 8>({a}",
                            f"kk < 0; ++kk)\n            wgmma_rs<T, NA, 1>(cols<NA / 8>({a}") for a in ("dv,", "dk,")]),
    "k12_no_stores": ("K12 without its dK/dV stores (no output)", [(K12_STORES, "")]),
    "k12_no_row_loads": ("K12 without its row inputs' loads (wrong dK/dV)",
                         [("2 * C::QT_BYTES + C::ROWS_BYTES);", "2 * C::QT_BYTES);"), (K12_ROW_LOADS, "")]),
    "dq_stages4": ("K13's ring 4 key tiles deep (head dims 32 and 64)",
                   [("static constexpr int STAGES = HD == 128 ? 6 : 8;          // K/V tiles in flight",
                     "static constexpr int STAGES = HD == 128 ? 6 : 4;          // K/V tiles in flight")]),
    # route "tf32" (K11, K12, K13 at fp32), probed at fp32; all but tf32_expf give wrong numbers by design
    "tf32_expf": ("route \"tf32\"'s exponential by expf, in place of ex2.approx of x * log2(e)",
                  [(TF32_EXP_K12, TF32_EXP_K12.replace("wg::exp_p(", "expf(")),
                   (TF32_EXP_K13, TF32_EXP_K13.replace("wg::exp_p(", "expf(")),
                   (TF32_EXP_K11, TF32_EXP_K11.replace("wg::exp_p(", "expf("))]),
    "tf32_no_nan_clamp": ("route \"tf32\"'s split without the clamp that keeps lo a NaN (NaN inputs then give "
                          "finite gradients; the same bits for finite inputs)",
                          [(TF32_LO, "  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));")]),
    "tf32_fwd_no_kv_loads": ("K11's route \"tf32\" without its K and V loads (wrong o)",
                             [("          mbar_expect_tx(&full[stage], 2 * C::KV_TILE + KEYS * 4);\n"
                               "          const uint32_t st = sst + stage * C::STAGE;\n"
                               "          tma_tile<KEYS, HD>(st, &map_k, heads_inner & 2, h, kt * KEYS, b, &full[stage]);\n"
                               "          tma_tile<KEYS, HD>(st + C::V_RAW, &map_v, heads_inner & 4, h, kt * KEYS, b, &full[stage]);\n",
                               "          mbar_expect_tx(&full[stage], KEYS * 4);\n"
                               "          const uint32_t st = sst + stage * C::STAGE;\n")]),
    "tf32_fwd_no_split": ("K11's route \"tf32\" without its split of K and V (wrong o)",
                          [(TF32_SPLIT_K11, "          fence_proxy_async();\n")]),
    "tf32_no_products": ("route \"tf32\" without its wgmma products",
                         [(f"for (int kk = 0; kk < KS; ++kk) mma<N>(d, {a}", f"for (int kk = 0; kk < 0; ++kk) mma<N>(d, {a}")
                          for a in ("ah[kk], desc_lo(kk), kk > 0 || !fresh);", "al[kk], desc(kk), 1);",
                                    "ah[kk], desc(kk), 1);")]),
    "tf32_products_only": ("route \"tf32\" with its products, barriers and ring alone: no split, exponential, "
                           "transposed loads or stores of P and dS",
                           [(TF32_SPLIT_K12, ""), (TF32_SPLIT_K13, ""), (TF32_SPLIT_K11, "          fence_proxy_async();\n"),
                            (TF32_EXP_K11, TF32_EXP_K11.replace("wg::exp_p(", "(")),
                            (TF32_P_SPLIT_K11, "        ph[kk][0] = ph[kk][1] = ph[kk][2] = ph[kk][3] = __float_as_uint(s[kk][0]);\n"
                                               "        pl[kk][0] = pl[kk][1] = pl[kk][2] = pl[kk][3] = 0u;\n"),
                            (TF32_EXP_K12, TF32_EXP_K12.replace("wg::exp_p(", "(")),
                            (TF32_EXP_K13, TF32_EXP_K13.replace("wg::exp_p(", "(")),
                            (TF32_COLS_LOADS, "      hi[kk][r] = off[r];\n      lo[kk][r] = off[r];"),
                            (TF32_B_STORES, ""), (TF32_TO_THREAD, "(void)buf;"),
                            *[(a, "const float4 p = make_float4(0.f, 0.f, 0.f, 0.f);") for a in TF32_P_READS]]),
}


def ptxas_check(build_log: str) -> dict:
    """From nvcc's ``-Xptxas=-v`` output: each kernel's registers and spill
    bytes, and ptxas's warnings that it serialised wgmma instructions; "ok"
    when no kernel of route "wgmma" spills and no wgmma is serialised."""
    kernels, name = {}, None
    for line in build_log.splitlines():
        got = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if got:
            name = got.group(1)
            kernels.setdefault(name, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            kernels[name]["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            kernels[name]["registers"] = int(regs.group(1))
    serialised = [line.strip() for line in build_log.splitlines() if "serializ" in line or "serialis" in line]
    spills = {k: v["spill_bytes"] for k, v in kernels.items() if "wgmma" in k and v.get("spill_bytes")}
    return {"kernels": kernels, "wgmma_spills": spills, "serialised": serialised,
            "ok": not spills and not serialised and any("wgmma" in k for k in kernels)}


def ptxas_log() -> str:
    """nvcc's ``-Xptxas=-v`` report of ``csrc/flash_attention.cu`` as it is:
    this process's build's, or, where the library came from the build
    directory, a build into ``.runs/flash_variants/``."""
    from colbert_tpu_torch.ops import _build

    if "flash_attention" in _build.build_logs:
        return _build.build_logs["flash_attention"]
    out = ROOT / ".runs" / "flash_variants"
    out.mkdir(parents=True, exist_ok=True)
    return subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "as_is.so"),
                           str(_build.CSRC / "flash_attention.cu")], check=True, capture_output=True, text=True).stderr


def variant_fns(name: str):
    """The C entry points of ``csrc/flash_attention.cu`` with :data:`VARIANTS`'
    swaps for ``name``, built into ``.runs/flash_variants/``."""
    import ctypes

    from colbert_tpu_torch.ops import _build, flash_attention as fa

    text = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once in flash_attention.cu: {old!r}")
        text = text.replace(old, new)
    out = ROOT / ".runs" / "flash_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out / f"{name}.so"),
                    str(out / f"{name}.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    fa.bind(lib)
    return (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_rows_launch)


def block_heights(device, label, shapes) -> None:
    """K11 route "wgmma" at 192-row blocks (the build's rule) and at 128, cold, in turns."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    fns = {"192": fa._fns(), "128": variant_fns("rows128")}
    for name, (B, nh) in shapes.items():
        g = torch.Generator(device).manual_seed(B * nh)
        heads = lambda: torch.randn((B, 384, nh, 64), generator=g, device=device).to(torch.bfloat16).transpose(1, 2)
        seg = torch.ones((B, 384), dtype=torch.int32, device=device)
        n_copies = max(1, -(-4 * chip_smoke.L2_BYTES // (3 * B * nh * 384 * 64 * 2)))
        copies = [(heads(), heads(), heads()) for _ in range(n_copies)]
        got = {"192": [], "128": []}
        for which in ("192", "128", "128", "192"):
            fa._resolved = fns[which]
            call = chip_smoke.in_turn(lambda x, i: fa._launch_forward(*x, seg, seg, chip_smoke.FLASH_SCALE), copies)
            got[which].append(chip_smoke.time_ms(call, warmup=n_copies + 2))
        fa._resolved = fns["192"]
        chip_smoke.log(f"[blocks] {name} ({B}, {nh}, 384, 64) K11 cold: 192-row blocks {got['192']} ms, "
                       f"128-row blocks {got['128']} ms [{label}]")


def probe_times(device, label, names) -> None:
    """K11, K12 and K13 of the source as it is and of each variant, cold at
    the retriever's shape, in turns (forward order, then reverse): route
    "wgmma" on bf16 inputs, and, for the variants of route "tf32"
    (``tf32_*``), on fp32 inputs with segment lengths from 64 to 384, each
    variant's dk, dv and dq held to the source's (``fp32_head_rel``)."""
    import torch

    for fp32 in (False, True):
        chosen = [name for name in names if name.startswith("tf32_") == fp32]
        if chosen:
            _probe(device, label, chosen, torch.float32 if fp32 else torch.bfloat16)


def _probe(device, label, names, dtype) -> None:
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    fns = {"default": fa._fns()}
    for name in names:
        fns[name] = variant_fns(name)
    B, nh, L = 68, 12, 384
    g = torch.Generator(device).manual_seed(0)
    heads = lambda: torch.randn((B, L, nh, 64), generator=g, device=device).to(dtype).transpose(1, 2)
    if dtype == torch.float32:
        seg = (torch.arange(L, device=device)[None, :] < torch.randint(64, L + 1, (B, 1), generator=g,
                                                                        device=device)).to(torch.int32)
    else:
        seg = torch.ones((B, L), dtype=torch.int32, device=device)
    copies = [(heads(), heads(), heads(), heads()) for _ in range(2)]
    o, l, m = fa._launch_forward(*copies[0][:3], seg, seg, chip_smoke.FLASH_SCALE)
    di, inv_l = fa._launch_rows(o, copies[0][3], l)
    own = (*copies[0][:3], seg, seg, chip_smoke.FLASH_SCALE, l, m, copies[0][3], di)
    got = {name: {"K11": [], "K12": [], "K13": []} for name in fns}
    for name in [*fns, *reversed(fns)]:
        fa._resolved = fns[name]
        k11 = chip_smoke.in_turn(lambda x, i: fa._launch_forward(*x[:3], seg, seg, chip_smoke.FLASH_SCALE), copies)
        k12 = chip_smoke.in_turn(lambda x, i: fa._launch_dkv(*x[:3], seg, seg, chip_smoke.FLASH_SCALE, l, m, x[3], di,
                                                             inv_l=inv_l), copies)
        k13 = chip_smoke.in_turn(lambda x, i: fa._launch_dq(*x[:3], seg, seg, chip_smoke.FLASH_SCALE, l, m, x[3], di,
                                                            inv_l=inv_l), copies)
        got[name]["K11"].append(chip_smoke.time_ms(k11, warmup=4))
        got[name]["K12"].append(chip_smoke.time_ms(k12, warmup=4))
        got[name]["K13"].append(chip_smoke.time_ms(k13, warmup=4))
    rel = {}
    if dtype == torch.float32:
        out = {}
        for name, fn in fns.items():
            fa._resolved = fn
            out[name] = (*fa._launch_dkv(*own, inv_l=inv_l), fa._launch_dq(*own, inv_l=inv_l))
        rel = {name: "; head_rel against the source " + str({w: fa.fp32_head_rel(a, b) for w, a, b in zip(
            ("dk", "dv", "dq"), out[name], out["default"])}) for name in fns}
    fa._resolved = fns["default"]
    for name, t in got.items():
        chip_smoke.log(f"[probe] {name}: K11 {t['K11']} ms, K12 {t['K12']} ms, K13 {t['K13']} ms cold at ({B}, {nh}, "
                       f"{L}, 64) {str(dtype).removeprefix('torch.')}{rel.get(name, '')} [{label}]")


def stress(device, label, n) -> None:
    """The wrapper's path ``n`` times over memory filled with NaN: outputs bit-equal to the first run's."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    for name, (B, nh) in (("retriever", (68, 12)), ("ce", (20, 16))):
        g = torch.Generator(device).manual_seed(B * nh + 1)
        heads = lambda: torch.randn((B, 384, nh, 64), generator=g, device=device).to(torch.bfloat16).transpose(1, 2)
        q, k, v, do = heads(), heads(), heads(), heads()
        lengths = torch.randint(1, 385, (B,), generator=g, device=device)
        seg = (torch.arange(384, device=device)[None, :] < lengths[:, None]).to(torch.int32)

        def run():
            o, l, m = fa.flash_forward(q, k, v, seg, seg, chip_smoke.FLASH_SCALE)
            return (o, l, m, *fa.flash_backward(q, k, v, seg, seg, chip_smoke.FLASH_SCALE, o, l, m, do))
        want = [t.clone() for t in run()]
        bad = 0
        for i in range(n):
            junk = torch.full((1 << 28,), float("nan"), device=device)  # 1 GiB of NaN into the allocator's blocks
            del junk
            got = run()
            torch.cuda.synchronize()
            diff = [w for w, a, b in zip(("o", "l", "m", "dq", "dk", "dv"), want, got) if not torch.equal(a, b)]
            if diff:
                bad += 1
                chip_smoke.log(f"[stress] {name} run {i}: {diff} differ")
        chip_smoke.log(f"[stress] {name} ({B}, {nh}, 384, 64): {n} runs, {bad} not bit-equal to the first [{label}]")


def embeddings_forward(record=None):
    """``BertEmbeddings.forward`` with ``F.embedding`` for the word ids and
    token types (in place of ``models/bert.py``'s ``lookup``); with
    ``record``, each call's (ids, token types, positions) and, in the
    backward, the gradient reaching the sum of the three lookups."""
    import torch
    import torch.nn.functional as F

    def forward(self, input_ids, token_type_ids, dtype, generator=None):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (F.embedding(input_ids, self.word_embeddings.weight.to(dtype))
             + F.embedding(positions, self.position_embeddings.weight.to(dtype))
             + F.embedding(token_type_ids, self.token_type_embeddings.weight.to(dtype)))
        if record is not None and x.requires_grad:
            entry = {"ids": input_ids.clone(), "types": token_type_ids.clone(), "positions": positions, "dtype": dtype}
            record.append(entry)
            x.register_hook(lambda g: entry.__setitem__("grad", g.clone()))
        return self.dropout(self.layernorm(x, dtype), self.dropout.seed(generator))
    return forward


@contextlib.contextmanager
def plain_lookups(record=None):
    """The model's embeddings by ``F.embedding`` alone (:func:`embeddings_forward`) inside the block."""
    from colbert_tpu_torch.models.bert import BertEmbeddings

    own = BertEmbeddings.forward
    BertEmbeddings.forward = embeddings_forward(record)
    try:
        yield
    finally:
        BertEmbeddings.forward = own


@contextlib.contextmanager
def deterministic_warnings(seen):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside the
    block; each distinct warning it gives is added to ``seen``."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
    for w in caught:
        seen.setdefault(str(w.message).split("\n")[0][:240], 0)
        seen[str(w.message).split("\n")[0][:240]] += 1


def flash_trainer(device, ctx):
    """A fresh flash trainer on phase 8b's config and data, and its sampler (phase 8e's setup, no remat)."""
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset
    from colbert_tpu_torch.training.dataset import RetrievalSampler

    cfg = ColbertConfig.from_dict(ctx["cfg"].to_dict())
    cfg.model.attention_impl, cfg.model.remat = "flash", "none"
    tok = cli._tokenizer(cfg)
    trainer = ColbertTrainer(cfg, tok, device=device)
    sampler = RetrievalSampler(RetrievalDataset.from_json(ctx["train_path"]), tok, cfg.train,
                               cfg.train.per_device_batch_size, is_eval=False)
    trainer._init_state(sampler.steps_per_epoch())
    return trainer, sampler


def embedding_ways():
    """Ways to compute an embedding table's gradient from (ids (N,), the
    output's gradient (N, H) bf16, rows V), each giving the (V, H) bf16
    gradient the lookup's backward gives: the model's (``models/bert.py::
    lookup_backward``: the one-hot product up to 16 rows, else the sorted
    two-level sum), ``F.embedding``'s own backward, the same under
    deterministic algorithms, ``index_put_`` accumulating in fp32, and for
    small tables the one-hot product in the gradient's dtype."""
    import torch
    import torch.nn.functional as F

    from colbert_tpu_torch.models.bert import lookup_backward

    def lookup(ids, g, V):
        return torch.ops.aten.embedding_dense_backward(g, ids, V, -1, False)

    def lookup_deterministic(ids, g, V):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return lookup(ids, g, V)
        finally:
            torch.use_deterministic_algorithms(False)

    def index_put(ids, g, V):
        acc = torch.zeros((V, g.shape[1]), dtype=torch.float32, device=g.device)
        return acc.index_put_((ids,), g.float(), accumulate=True).to(g.dtype)

    def one_hot(ids, g, V):
        return (F.one_hot(ids, V).to(g.dtype).t() @ g) if V <= 512 else None

    def csr(ids, g, V):  # the one-hot product as a sparse CSR matrix times the gradient in fp32 (cuSPARSE)
        sorted_ids, order = torch.sort(ids, stable=True)
        first = torch.searchsorted(sorted_ids, torch.arange(V + 1, device=ids.device))
        a = torch.sparse_csr_tensor(first, order, torch.ones(ids.numel(), device=ids.device), size=(V, ids.numel()))
        return (a @ g.float()).to(g.dtype)
    return {"model": lookup_backward, "lookup": lookup, "lookup_deterministic": lookup_deterministic,
            "index_put": index_put, "one_hot": one_hot, "csr": csr}


def embedding_repeats(device, label, n, ctx) -> None:
    """The embeddings' backward alone, replayed ``n`` times on what one flash
    train step gave it, each way of :func:`embedding_ways`, with its time;
    then one step under deterministic algorithms (see the module docstring)."""
    import torch

    from colbert_tpu_torch.models.bert import BertEmbeddings

    record = []
    trainer, sampler = flash_trainer(device, ctx)
    batch = next(iter(sampler.epoch(0)))
    with plain_lookups(record):
        trainer.compute_grads(batch, 0)
    emb = next(m for m in trainer.model.modules() if isinstance(m, BertEmbeddings))
    V = emb.word_embeddings.weight.shape[0]
    cases = []
    for i, r in enumerate(record):
        g = r["grad"].reshape(-1, r["grad"].shape[-1])
        cases.append((f"pass {i} word ids", r["ids"].reshape(-1), g, V))
        cases.append((f"pass {i} token types", r["types"].reshape(-1), g, emb.token_type_embeddings.weight.shape[0]))
    gen = torch.Generator(device).manual_seed(0)
    big = max(cases, key=lambda c: c[1].numel())
    cases.append(("a 128-word vocabulary", torch.randint(1, 128, big[1].shape, generator=gen, device=device),
                  big[2], V))
    for what, ids, g, rows in cases:
        counts = torch.bincount(ids)
        desc = (f"{what}: {ids.numel()} lookups into {rows} rows, {int((counts > 0).sum())} distinct, the most "
                f"repeated {int(counts.max())} times")
        first_way = None
        for way, fn in embedding_ways().items():
            first = fn(ids, g, rows)
            if first is None:
                continue
            first_way = first_way if first_way is not None else first
            differ = sum(not torch.equal(fn(ids, g, rows).view(torch.int16), first.view(torch.int16))
                         for _ in range(n))
            ms = chip_smoke.time_ms(lambda: fn(ids, g, rows))
            card = chip_smoke.device_ms(lambda: fn(ids, g, rows))
            host = chip_smoke.host_ms(lambda: fn(ids, g, rows))
            err = float((first.float() - first_way.float()).abs().max())
            chip_smoke.log(f"[embedding] {desc}; {way}: {differ} of {n} replays not bit-equal to the first, "
                           f"{ms:.4f} ms a call as issued, {card:.4f} on the card alone, {host:.4f} on the host "
                           f"clock; max|d| from the model's first {err:.3e} [{label}]")
    # the lookup's backward by table size: the doc pass's gradient, ids over the first min(rows, 128) rows or all
    for rows in (2, 16, 128, 512, 1024, 2048, 4096, 8192, 21128):
        for span in sorted({min(rows, 128), rows}):
            ids = torch.randint(0, span, big[1].shape, generator=gen, device=device)
            first = embedding_ways()["lookup"](ids, big[2], rows)
            differ = sum(not torch.equal(embedding_ways()["lookup"](ids, big[2], rows).view(torch.int16),
                                         first.view(torch.int16)) for _ in range(n))
            chip_smoke.log(f"[embedding] table of {rows} rows, {big[1].numel()} ids over its first {span}: lookup "
                           f"{differ} of {n} replays not bit-equal to the first [{label}]")
    seen = {}
    with plain_lookups(), deterministic_warnings(seen):
        trainer.compute_grads(batch, 0)
        torch.cuda.synchronize()
    chip_smoke.log(f"[embedding] one flash train step (F.embedding's backward) under deterministic algorithms: "
                   f"{len(seen)} distinct warnings {seen or ''} [{label}]")


def train_repeat(device, label, n, ctx) -> None:
    """Phase 8e ``n`` times after phase 8b; each 8e's failure printed, and counted."""
    failed = 0
    for i in range(n):
        try:
            chip_smoke.phase_remat(device, label, ctx)
        except AssertionError as e:
            failed += 1
            chip_smoke.log(f"[train] phase 8e repeat {i} failed: {str(e)[:300]}")
    chip_smoke.log(f"[train] phase 8e {n} times after one phase 8b: {failed} failed [{label}]")


def _digest(t) -> int:
    """A position-weighted sum of ``t``'s bits: equal tensors, equal digests."""
    import torch

    bits = t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()]).reshape(-1).to(torch.int64)
    return int((bits * (torch.arange(bits.numel(), device=t.device) % 65521 + 1)).sum())


def train_trace(device, label, n, ctx, deterministic=False) -> None:
    """Two train steps with flash (phase 8e's setup, no remat) ``n`` times,
    each flash launch's inputs and outputs and the first step's gradients
    digested: the first launch whose outputs differ from the first repeat's,
    whether its inputs did, and which gradients differ."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    names = ("_launch_forward", "_launch_rows", "_launch_dkv", "_launch_dq")
    own = {name: getattr(fa, name) for name in names}

    def hooked(name, rec):
        def call(*args, **kw):
            out = own[name](*args, **kw)
            tensors = [a for a in (*args, *kw.values()) if isinstance(a, torch.Tensor)]
            outs = out if isinstance(out, tuple) else (out,)
            rec.append((name, [_digest(a) for a in tensors], [_digest(o) for o in outs if o is not None]))
            return out
        return call
    runs, seen = [], {}
    for _ in range(n):
        rec = []
        for name in names:
            setattr(fa, name, hooked(name, rec))
        try:
            with deterministic_warnings(seen) if deterministic else contextlib.nullcontext():
                trainer, sampler = flash_trainer(device, ctx)
                losses, params = [], None
                for g, batch in zip(range(2), sampler.epoch(0)):
                    losses.append(float(trainer.compute_grads(batch, g)))
                    if params is None:  # the first step's gradients, in the backward's order
                        params = {k: _digest(p.grad) for k, p in reversed(list(trainer.model.named_parameters()))
                                  if p.grad is not None}
                    trainer.optimizer.step()
                del trainer
        finally:
            for name in names:
                setattr(fa, name, own[name])
        runs.append((losses, rec, params))
    if deterministic:
        chip_smoke.log(f"[trace] under deterministic algorithms: {len(seen)} distinct warnings {seen or ''}")
    for i, (losses, rec, params) in enumerate(runs):
        first = next((j for j, (a, b) in enumerate(zip(runs[0][1], rec)) if a != b), None)
        moved = [k for k in params if params[k] != runs[0][2][k]]
        chip_smoke.log(f"[trace] repeat {i}: {len(moved)} gradients of step 1 differ from repeat 0's, last layers "
                       f"first: {moved[:12]}")
        where = "none" if first is None else (f"launch {first} {rec[first][0]}: inputs equal "
                                              f"{runs[0][1][first][1] == rec[first][1]}, outputs "
                                              f"{[x == y for x, y in zip(runs[0][1][first][2], rec[first][2])]}")
        chip_smoke.log(f"[trace] repeat {i}: losses {losses}; first launch differing from repeat 0: {where} [{label}]")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the checks alone, no times")
    ap.add_argument("--blocks", action="store_true", help="K11 at 192-row blocks against 128-row blocks")
    ap.add_argument("--variant", action="append", default=[], choices=VARIANTS,
                    help="phase 8a on this variant of the source")
    ap.add_argument("--probe", action="append", default=[], choices=VARIANTS,
                    help="K11, K12 and K13 times alone, unchecked, on this variant of the source")
    ap.add_argument("--train", type=int, default=0, metavar="N",
                    help="phase 8b once, then phase 8e N times")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="two flash train steps N times, each launch digested; the first that differs")
    ap.add_argument("--embedding", type=int, default=0, metavar="N",
                    help="the embeddings' backward alone replayed N times on one train step's inputs")
    ap.add_argument("--lookup", action="store_true",
                    help="--train and --trace with the token types by F.embedding, as the model had them")
    ap.add_argument("--deterministic", action="store_true",
                    help="--trace under torch.use_deterministic_algorithms(True, warn_only=True)")
    ap.add_argument("--stress", type=int, default=0, metavar="N",
                    help="the wrapper's path N times over NaN-filled memory, bit-equal to the first run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from colbert_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    device = torch.device("cuda", 0)
    label = chip_smoke.card_label()
    chip_smoke.log(label)
    t0 = time.perf_counter()
    lib = fa._kernel_lib()
    chip_smoke.log(f"[build] flash_attention.cu in {time.perf_counter() - t0:.1f} s")
    log = ptxas_log()
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "arning", "wgmma", "Function properties", "Compiling")):
            chip_smoke.log(f"[build] {line.strip()}")
    for name, c in sass_counts(lib._name).items():
        chip_smoke.log(f"[sass] {name}: {c}")
    check = ptxas_check(log)
    chip_smoke.log(f"[check] route \"wgmma\" kernels: no spills and no serialised wgmma {check['ok']} (spills "
                   f"{check['wgmma_spills']}, serialised {check['serialised']}); registers "
                   f"{ {k: v.get('registers') for k, v in check['kernels'].items()} }")
    shapes = {"retriever": (68, 12), "ce": (20, 16), "encode": (384, 12), "unpadded": (16, 12), "past_128": (16, 12)}
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        if args.quick:
            import numpy as np

            rng = np.random.default_rng([chip_smoke.SEED, 8])
            lengths = {"retriever": rng.integers(64, 385, size=68), "ce": rng.integers(64, 385, size=20),
                       "encode": rng.integers(16, 385, size=384), "unpadded": np.full(16, 384),
                       "past_128": np.where(np.arange(16) % 2, 129, 257)}
            for i, (name, (B, nh)) in enumerate(shapes.items()):
                chip_smoke.flash_case(device, name, B, nh, lengths[name], chip_smoke.SEED + i, False, label)
        else:
            chip_smoke.phase_flash_kernels(device, Path(tmp), label, shapes=shapes)
    if args.blocks:
        block_heights(device, label, {k: shapes[k] for k in ("retriever", "ce", "encode")})
    for name in args.variant:
        own = fa._fns()
        fa._resolved = variant_fns(name)
        chip_smoke.log(f"[variant] {name}: {VARIANTS[name][0]}")
        try:
            with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
                chip_smoke.phase_flash_kernels(device, Path(tmp), f"{label}; variant {name}", shapes=shapes)
        except AssertionError as e:
            chip_smoke.log(f"[variant] {name} failed its checks: {str(e)[:400]}")
        fa._resolved = own
    if args.probe:
        probe_times(device, label, args.probe)
    if args.stress:
        stress(device, label, args.stress)
    if args.train or args.trace or args.embedding:
        with tempfile.TemporaryDirectory(prefix="flash_variants_train_") as tmp:
            _, ctx = chip_smoke.phase_train(device, Path(tmp), label, steps=5, attention_impl="flash", tag="phase8b")
            if args.embedding:
                embedding_repeats(device, label, args.embedding, ctx)
            with plain_lookups() if args.lookup else contextlib.nullcontext():
                if args.train:
                    train_repeat(device, label, args.train, ctx)
                if args.trace:
                    chip_smoke.log(f"[trace] word ids and token types by {'F.embedding' if args.lookup else 'the model lookup'}")
                    train_trace(device, label, args.trace, ctx, args.deterministic)
    chip_smoke.log(label)
    return 0 if check["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
