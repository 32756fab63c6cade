#!/usr/bin/env python3
"""Bring-up run of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, and drives two
serving paths at full width, with weights drawn from a seeded
``torch.Generator``:

* the paged path: qwen2-1.5b (28 layers, d_model 1536, bf16) through the
  page-level ``Infer`` path (``InferenceImpl.infer``: device page decode
  -> ``PagedBatcher`` -> paged attention kernels), and then through the
  port's Bebop RPC server over TCP (``rpc_serve``: the nine methods,
  seeded sampling with n = 3 forks and rejection-sampled spec decode,
  preemption and swap at a 1,100-key context, the launcher's ``--once``);
  gemma-2b (18 layers, d_model 2048, 8 query heads over one KV head of
  256, vocab 256,000, bf16) on the same path (``gemma_serve``); and the
  replicated tier (``fleet_serve``: the replica router over two
  in-process replicas of qwen2-1.5b on TCP, with a replica killed under
  a stream and under an ``Infer``, and hedging over a slow link; then the
  launcher with ``--replicas 2`` as subprocesses, one replica SIGKILLed
  and restarted by its supervisor);
* the dense path: the same model with ``ServeConfig(paged=False)``
  (``ContinuousBatcher`` -> ``Engine.generate``: flash attention kernel
  in the prefill), the paged batcher's dense fallback and ``score_page``;
  and recurrentgemma-9b (38 layers, d_model 4096, bf16), whose only
  serving path is the dense one (flash attention with a 2,048 window and
  the RG-LRU scan kernel), including a 2,000-token prompt whose decode
  wraps the ring cache; and rwkv6-7b (32 layers, d_model 4096, bf16),
  attention-free, whose prefill and scoring run the WKV scan kernel,
  including a 2,000-token prompt.

Each path must launch its kernels (counts set to 0 just before it and
read just after) and match a replay through the plain versions
(``attention_impl="reference"``).  Each kernel is then timed beside its
plain version, its memory/compute bound and, where one PyTorch call
computes the same function, that call.

Every phase prints ``[phase] ok|FAIL <seconds> {json}``; the first failure
ends the run with a nonzero exit.  ``--decode-timing`` (with ``--src`` for
another checkout's ``src``) runs only the page decode timing rows, and
``--scan-timing`` only the RG-LRU and WKV scan rows.  The line before the last is the
``kernels`` JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without ``src/repro_torch`` beside it, the script
exits nonzero and prints no result.  It imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import queue
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SEED = 0
# main-path shapes: qwen2-1.5b at full width under the default ServeConfig
HQ, HKV, HD, BS = 12, 2, 128, 16
# gemma-2b's attention heads: 8 query heads over one KV head, head_dim 256
GEMMA_HEADS = (8, 1, 256)
PROMPT_LENS = (16, 40, 64, 97, 128, 200, 256, 331, 400)
NEW_TOKENS = 32
HYBRID_PROMPTS = (0, 3, 5, 7, 8)    # PROMPT_LENS 16, 97, 200, 331, 400
# the paged rows' contexts halfway through the serve wave (prompts 2-9 at
# 16 of their 32 new tokens): the attention timing shape
ATTN_CTX = tuple(n + NEW_TOKENS // 2 for n in PROMPT_LENS[1:])
LONG_PROMPT, LONG_NEW = 2000, 100   # decode crosses the 2,048 window
RWKV_LONG_NEW = 64                  # rwkv6-7b's 2,000-token request
SCORE_TOL = 0.02    # mean log-prob, kernel path vs plain replay
# bf16 tolerances.  Attention outputs: the kernel and the plain version
# both accumulate in fp32 but in another order, then round to bf16 — one
# or two bf16 ulps at |o| <= 4 is <= 2e-2 + 2e-2 * |o|.  Logits: with this
# init (embedding N(0, 0.02^2), tied unembed after an RMSNorm) a logit has
# a std of about 0.02 * sqrt(1536) ~ 0.78, and the top two of 151,936 such
# logits are typically ~0.16 apart.  28 layers of bf16 activations carry
# the attention's rounding forward; the largest logit difference measured
# on an H100 was 0.070 (PERF.md), and the limit is about twice that.  A
# greedy token split is a fault where the reference's top-2 margin exceeds
# SPLIT_MARGIN, well under the typical gap, and a phase fails on more than
# MAX_SPLITS splits of any margin.
ATTN_ATOL = ATTN_RTOL = 2e-2
F32_ATOL, F32_RTOL = 3e-5, 1e-4     # the JAX kernel tests' f32 tolerances
# the RG-LRU kernel rounds its multiply and add apart, as the plain loop
# does, so float32 h and h_final must be bit-equal to the plain version's
LOGIT_TOL = 0.15
# the WKV scan rounds every product and sum as the plain loop does and sums
# o over K in the same pairwise tree, so o and the final state must be
# bit-equal to the plain version's in both dtypes
# rwkv6-7b's first-step logits, WKV kernel against its plain version: the
# kernel's o equals the plain version's bit for bit, and nothing else on
# the path differs, so the logits must be equal
RWKV_LOGIT_TOL = 0.0
SPLIT_MARGIN = 0.05
MAX_SPLITS = 2


def emit(line: str) -> None:
    print(line, flush=True)


class Phase:
    """Run one phase: print its ok/FAIL line, exit the script on failure."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        t0 = time.perf_counter()
        try:
            info = fn()
        except BaseException:  # noqa: BLE001 - report, then stop the run
            dt = time.perf_counter() - t0
            err = traceback.format_exc()
            emit(f"[{self.name}] FAIL {dt:.1f}s "
                 + json.dumps({"error": err.strip().splitlines()[-1]}))
            print(err, file=sys.stderr, flush=True)
            sys.exit(1)
        emit(f"[{self.name}] ok {time.perf_counter() - t0:.1f}s "
             + json.dumps(info))
        return info


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--decode-timing", action="store_true",
                    help="only time the page decode rows (decode_rows) and "
                         "print them: an A/B of two checkouts' decode "
                         "kernels runs this once per checkout")
    ap.add_argument("--scan-timing", action="store_true",
                    help="only time the RG-LRU and WKV scan rows (scan_rows, "
                         "T 400 and T 2000, without the plain loops) and "
                         "print them with ptxas's report of the two builds: "
                         "an A/B of two checkouts' scan kernels runs this "
                         "once per checkout")
    ap.add_argument("--src", help="the directory holding the repro_torch "
                                  "to run (default: src beside this script)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src) if args.src else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    state = {"src": src}

    @Phase("gpu")
    def _gpu():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        emit(smi)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state["smi"] = smi
        return {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "tf32_matmul": False, "tf32_cudnn": False}

    from repro_torch.kernels import bebop_decode as bd
    if args.decode_timing:
        def _decode_timing():
            gen = torch.Generator(device=dev).manual_seed(SEED + 4)
            flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                device=dev)
            return {"card": state["smi"], "src": src,
                    **decode_rows(torch, bd, dev, gen, flush)}
        Phase("decode_timing")(_decode_timing)
        return 0
    if args.scan_timing:
        def _scan_timing():
            from repro_torch.kernels import build
            from repro_torch.kernels import rglru_scan as rg
            from repro_torch.kernels import rwkv6_scan as rw
            libs = build.build_all(["rglru_scan", "rwkv6_scan"])
            gen = torch.Generator(device=dev).manual_seed(SEED + 4)
            flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                device=dev)
            return {"card": state["smi"], "src": src,
                    "libraries": {k: v.name for k, v in libs.items()},
                    "ptxas": _ptxas(build),
                    **scan_rows(torch, rg, rw, dev, gen, flush, plain=False)}
        Phase("scan_timing")(_scan_timing)
        return 0
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    @Phase("build")
    def _build():
        # ptxas refuses a build of the attention kernels or the scans that
        # spills (build.SOURCE_FLAGS), so this phase fails on a spill there
        libs = build.build_all()
        return {"libraries": {k: v.name for k, v in libs.items()},
                "ptxas": _ptxas(build),
                "source_flags": {k: " ".join(v) for k, v in
                                 build.SOURCE_FLAGS.items()}}

    state.update(decode_kernel=Phase("decode_kernel")(
        lambda: check_decode(torch, bd, dev)))
    state.update(attention_kernels=Phase("attention_kernels")(
        lambda: check_attention(torch, pa, dev)))
    state.update(flash_kernel=Phase("flash_kernel")(
        lambda: check_flash(torch, fa, dev)))
    state.update(rglru_kernel=Phase("rglru_kernel")(
        lambda: check_rglru(torch, rg, dev)))
    state.update(rwkv_kernel=Phase("rwkv_kernel")(
        lambda: check_rwkv(torch, rw, dev)))
    Phase("model")(lambda: check_model(torch, dev, state))
    Phase("serve")(lambda: serve(torch, bd, pa, dev, state))
    Phase("profile")(lambda: profile(torch, dev, state))
    Phase("rpc_serve")(lambda: rpc_serve(torch, bd, pa, dev, state))
    Phase("gemma_serve")(lambda: gemma_serve(torch, bd, pa, dev, state))
    Phase("fleet_serve")(lambda: fleet_serve(torch, bd, pa, dev, state))
    Phase("dense_serve")(lambda: dense_serve(torch, fa, dev, state))
    Phase("hybrid_serve")(lambda: hybrid_serve(torch, bd, fa, rg, dev,
                                                 state))
    Phase("rwkv_serve")(lambda: rwkv_serve(torch, bd, rw, dev, state))
    Phase("timing")(lambda: timing(torch, bd, pa, fa, rg, rw, dev, state))
    emit(json.dumps({"kernels": state["kernels"]}))
    emit(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _ptxas(build):
    """ptxas's register and spill lines of the libraries this process
    built, one of each."""
    return sorted({ln.strip() for log in build.build_logs.values()
                   for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln})


# -- kernel checks -----------------------------------------------------------

#: (offset, count, wire, out) over a 64-byte record: every wire dtype,
#: several fields in one pass, integer widening and narrowing
DECODE_PLAN = ((0, 3, "uint32", "int32"), (12, 2, "int32", "int32"),
               (20, 2, "float32", "float32"), (28, 3, "uint16", "uint16"),
               (34, 2, "bfloat16", "float32"), (38, 2, "float16", "float32"),
               (42, 4, "uint8", "uint8"), (46, 1, "bool", "uint8"),
               (47, 1, "byte", "float32"), (48, 2, "uint32", "uint32"),
               (56, 2, "uint16", "int32"), (60, 1, "int32", "float32"))


def _bits(t):
    import torch
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


#: (N, stride, lead rows, plan offset): pages of 64-byte records, a stride
#: that is not a multiple of 16, a row slice that starts off a 16-byte
#: boundary (the page begins `lead` rows into a larger one), and rows too
#: wide to stage in shared memory (decoded in place), the plan shifted to
#: their end
DECODE_PAGES = tuple((n, 64, 0, 0) for n in (1, 7, 255, 1000, 4097)) + (
    (4097, 67, 1, 0), (255, 100, 3, 20), (3, 50_000, 1, 49_900))


#: (wire, out) of a one-field plan that is the page's own bytes when it
#: spans the row: the kernel copies such a column (the served token pages)
DECODE_BITCASTS = (("uint32", "int32"), ("int32", "uint32"),
                   ("float32", "float32"), ("uint16", "uint16"),
                   ("uint8", "uint8"))


def check_decode(torch, bd, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = 0
    for n, stride, lead, shift in DECODE_PAGES:
        big = torch.randint(0, 256, (n + lead, stride), generator=gen,
                            device=dev, dtype=torch.int32).to(torch.uint8)
        page = big[lead:]
        plan = [(off + shift, cnt, wd, od)
                for off, cnt, wd, od in DECODE_PLAN]
        bitcasts = [(0, stride // bd._WIDTH[wd], wd, od)
                    for wd, od in DECODE_BITCASTS
                    if stride % bd._WIDTH[wd] == 0]
        what = f"N={n} stride {stride} at byte {page.data_ptr() % 16} mod 16"
        got = bd.decode_columns(page, plan)
        want = bd.decode_columns_plain(page, plan)
        for f, a, b in zip(plan, got, want):
            if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
                raise AssertionError(f"decode_columns differs at {what} {f}")
            cases += 1
        for off, cnt, wd, od in plan + bitcasts:
            a = bd.decode_column(page, offset=off, count=cnt, wire_dtype=wd,
                                 out_dtype=od)
            b = bd.decode_columns_plain(page, [(off, cnt, wd, od)])[0]
            if not torch.equal(_bits(a), _bits(b)):
                raise AssertionError(f"decode_column differs at {what} {wd}")
            cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "bit_exact": True, "max_abs_err": 0.0,
            "pages": [list(p) for p in DECODE_PAGES]}


def _pool(torch, gen, dev, n_blocks, dtype, heads=(HQ, HKV, HD)):
    shape = (n_blocks, heads[1], BS, heads[2])
    return (torch.randn(shape, generator=gen, device=dev).to(dtype),
            torch.randn(shape, generator=gen, device=dev).to(dtype))


def _tables(torch, gen, dev, b, m, n_blocks):
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    return perm[:b * m].reshape(b, m).to(torch.int32)


def _close(torch, a, b, atol, rtol):
    err = (a.float() - b.float()).abs()
    ok = bool((err <= atol + rtol * b.float().abs()).all())
    return ok, float(err.max())


#: (table width M, pool blocks, decode contexts, prefill starts) at the
#: main path's heads and block size, B 8: contexts up to 1,024 keys, and up
#: to 2,048 (the served cache stops at 1,024).  Each has a ctx == 0 row,
#: and a padded decode row beside the prefill chunks (rows 1 and 7).
ATTN_TABLES = ((64, 513, (0, 1, 17, 100, 255, 400, 777, 1024),
                (0, 5, 64, 300, 500, 900, 1000, 37)),
               (128, 1025, (0, 1025, 1100, 1500, 2000, 2047, 2048, 1024),
                (0, 1000, 1500, 1990, 2016, 1024, 1063, 1900)))


def _attn_inputs(torch, gen, dev, b, t, m, n_blocks, dtype,
                 heads=(HQ, HKV, HD)):
    kp, vp = _pool(torch, gen, dev, n_blocks, dtype, heads)
    tables = _tables(torch, gen, dev, b, m, n_blocks)
    q = torch.randn((b, heads[0], t, heads[2]), generator=gen,
                    device=dev).to(dtype)
    return q, kp, vp, tables


def check_attention(torch, pa, dev):
    """Both paged kernels against their plain versions at qwen2-1.5b's
    heads (bf16 and f32) and at gemma-2b's (Hq 8, Hkv 1, D 256; bf16)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = (torch.bfloat16, ATTN_ATOL, ATTN_RTOL)
    out = {}
    for heads, name, dtypes in (
            ((HQ, HKV, HD), "", (bf16, (torch.float32, F32_ATOL, F32_RTOL))),
            (GEMMA_HEADS, "gemma_", (bf16,))):
        out.update(_check_paged(torch, pa, dev, gen, heads, name, dtypes))
    torch.cuda.synchronize()
    out["tolerance_bf16"] = {"atol": ATTN_ATOL, "rtol": ATTN_RTOL}
    out["tolerance_f32"] = {"atol": F32_ATOL, "rtol": F32_RTOL}
    out["max_bf16_mismatch"] = MAX_BF16_MISMATCH
    return out


def _check_paged(torch, pa, dev, gen, heads, name, dtypes):
    """Both paged kernels at ``heads`` (Hq, Hkv, D) for each of ``dtypes``
    (dtype, atol, rtol): decode, T 5 and T 32 over ATTN_TABLES, with
    unlisted blocks poisoned to show they never leak; then the share of
    bf16 outputs that differ from the plain version's at the timing
    contexts.  Keys are prefixed with ``name``."""
    b, (hq, _, hd) = 8, heads
    out = {}
    for dtype, atol, rtol in dtypes:
        tag = name + ("bf16" if dtype == torch.bfloat16 else "f32")
        for m, n_blocks, ctx, starts in ATTN_TABLES:
            tag_m = f"{tag}_keys{m * BS}"
            q, kp, vp, tables = _attn_inputs(torch, gen, dev, b, 1, m,
                                             n_blocks, dtype, heads)
            q = q[:, :, 0]
            # decode: mixed context lengths, one ctx == 0 row (emits zeros)
            ctx = torch.tensor(ctx, dtype=torch.int32, device=dev)
            got = pa.paged_attention(q, kp, vp, tables, ctx)
            want = pa.paged_attention_plain(q, kp, vp, tables, ctx)
            ok, err = _close(torch, got, want, atol, rtol)
            if not ok or bool(got[0].any()):
                raise AssertionError(
                    f"decode {tag_m}: max err {err}, ctx==0 row zero: "
                    f"{not bool(got[0].any())}")
            out[f"decode_{tag_m}_max_abs_err"] = err
            # unlisted blocks never leak into the output
            listed = torch.zeros(n_blocks, dtype=torch.bool, device=dev)
            listed[tables.long().reshape(-1)] = True
            ks, vs = kp.clone(), vp.clone()
            ks[~listed] = 1e3
            vs[~listed] = -1e3
            if not torch.equal(pa.paged_attention(q, ks, vs, tables, ctx),
                               got):
                raise AssertionError(f"decode {tag_m}: unlisted blocks "
                                     f"leaked")
            # prefill / mixed (T = 32) and verify (T = spec_len + 1 = 5)
            # tiles: decode rows padded with repeated positions beside
            # prefill chunks
            for t in (32, 5):
                qpos = (torch.tensor(starts, device=dev)[:, None]
                        + torch.arange(t, device=dev)[None]).clamp(
                            max=m * BS - 1)
                qpos[1] = 19                      # a padded decode row
                qpos[7] = 0                       # decode at position 0
                qpos = qpos.to(torch.int32)
                q = torch.randn((b, hq, t, hd), generator=gen,
                                device=dev).to(dtype)
                got = pa.paged_prefill_attention(q, kp, vp, tables, qpos)
                want = pa.paged_prefill_attention_plain(q, kp, vp, tables,
                                                        qpos)
                ok, err = _close(torch, got, want, atol, rtol)
                if not ok:
                    raise AssertionError(f"prefill T={t} {tag_m}: max err "
                                         f"{err}")
                out[f"prefill_t{t}_{tag_m}_max_abs_err"] = err
                if not torch.equal(pa.paged_prefill_attention(
                        q, ks, vs, tables, qpos), got):
                    raise AssertionError(f"prefill T={t} {tag_m}: unlisted "
                                         f"blocks leaked")
    # the share of bf16 outputs that differ from the plain version's at the
    # timing shape, held to flash's limit (the same f32 sums, P split into
    # bf16 hi + lo, one rounding to bf16)
    m = _table_width(ATTN_CTX)
    for t in (1, 5, 32):
        q, kp, vp, tables = _attn_inputs(torch, gen, dev, b, t, m, 513,
                                         torch.bfloat16, heads)
        qpos = torch.tensor([[c - t + i for i in range(t)] for c in ATTN_CTX],
                            dtype=torch.int32, device=dev)
        got = pa.paged_prefill_attention(q, kp, vp, tables, qpos) if t > 1 \
            else pa.paged_attention(q[:, :, 0], kp, vp, tables,
                                    qpos[:, 0] + 1)[:, :, None]
        want = pa.paged_prefill_attention_plain(q, kp, vp, tables, qpos)
        share = float((got != want).float().mean())
        out[f"{name}bf16_mismatch_share@T{t}"] = share
        if share > MAX_BF16_MISMATCH:
            raise AssertionError(
                f"paged bf16 {name}T {t}: {share:.4%} of outputs differ from "
                f"the plain version's (limit {MAX_BF16_MISMATCH:.0%})")
    out[f"{name}heads"] = {"hq": heads[0], "hkv": heads[1], "d": heads[2]}
    return out


def _table_width(ctx):
    """The power-of-two table width that holds the longest context."""
    m = 1
    while m * BS < max(ctx):
        m <<= 1
    return m


#: (Tq, S, causal, window, q_offset): prefill shapes (Tq == S, ragged),
#: queries at an offset, non-causal, both windows at S 2100, and rows
#: whose window holds no key (qpos 14..17 over keys 0..9, window 8)
FLASH_CASES = ((1, 1, True, None, 0), (7, 7, True, None, 0),
               (128, 128, True, None, 0), (400, 400, True, None, 0),
               (64, 300, True, None, 236), (7, 100, True, None, 50),
               (100, 333, False, None, 0), (2100, 2100, True, 8, 0),
               (2100, 2100, True, 2048, 0), (4, 10, True, 8, 14))
#: (Hq, Hkv, D): qwen2-1.5b and recurrentgemma-9b
FLASH_HEADS = ((12, 2, 128), (16, 1, 256))
#: the full-width prefills the main paths give the flash kernel, B 1,
#: causal: qwen2-1.5b's longest served prompt, recurrentgemma-9b's long one,
#: and gemma-2b's heads at T 400 (its dense fallback's shape)
#: (name: Hq, Hkv, D, T, window)
FLASH_FULL = {"qwen2": (HQ, HKV, HD, max(PROMPT_LENS), None),
              "recurrentgemma": (16, 1, 256, LONG_PROMPT, 2048),
              "gemma": (*GEMMA_HEADS, max(PROMPT_LENS), None)}
#: the share of bf16 outputs at FLASH_FULL that may differ from the plain
#: version's.  Both sum in f32 and round once to bf16, so they differ only
#: where the two f32 sums straddle a rounding boundary: with the kernel's
#: f32 error (~1e-6 relative, P split into bf16 hi + lo) against a bf16
#: ulp of 2^-8, a few in a thousand.  A P rounded to one bf16 errs by up
#: to 2^-9 relative, half a bf16 ulp, and would move far more.
MAX_BF16_MISMATCH = 0.01


def check_flash(torch, fa, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out = {}
    for dtype, atol, rtol in ((torch.float32, F32_ATOL, F32_RTOL),
                              (torch.bfloat16, ATTN_ATOL, ATTN_RTOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        worst = 0.0
        for hq, hkv, d in FLASH_HEADS:
            for tq, s, causal, window, off in FLASH_CASES:
                b = 1 if s > 1000 else 2
                q = torch.randn((b, hq, tq, d), generator=gen,
                                device=dev).to(dtype)
                k = torch.randn((b, hkv, s, d), generator=gen,
                                device=dev).to(dtype)
                v = torch.randn((b, hkv, s, d), generator=gen,
                                device=dev).to(dtype)
                kw = dict(causal=causal, window=window, q_offset=off)
                got = fa.flash_attention(q, k, v, **kw)
                want = fa.flash_attention_plain(q, k, v, **kw)
                ok, err = _close(torch, got, want, atol, rtol)
                case = f"{tag} Hq {hq} Hkv {hkv} D {d} Tq {tq} S {s} " \
                       f"causal {causal} window {window} q_offset {off}"
                if not ok:
                    raise AssertionError(f"flash {case}: max err {err}")
                if window is not None:
                    qpos = torch.arange(tq, device=dev) + off
                    empty = (qpos - (s - 1)) >= window
                    if bool(got[:, :, empty].any()):
                        raise AssertionError(f"flash {case}: a row with no "
                                             f"valid key is not zero")
                worst = max(worst, err)
        out[f"{tag}_max_abs_err"] = worst
    for name, (hq, hkv, d, t, window) in FLASH_FULL.items():
        q, k, v = (torch.randn((1, h, t, d), generator=gen, device=dev).to(
            torch.bfloat16) for h in (hq, hkv, hkv))
        got = fa.flash_attention(q, k, v, window=window)
        want = fa.flash_attention_plain(q, k, v, window=window)
        ok, err = _close(torch, got, want, ATTN_ATOL, ATTN_RTOL)
        share = float((got != want).float().mean())
        out[f"bf16_mismatch_share@{name}_T{t}"] = share
        if not ok or share > MAX_BF16_MISMATCH:
            raise AssertionError(
                f"flash bf16 {name} T {t}: max err {err}, {share:.4%} of "
                f"outputs differ from the plain version's (limit "
                f"{MAX_BF16_MISMATCH:.0%})")
    torch.cuda.synchronize()
    out["cases"] = 2 * len(FLASH_HEADS) * len(FLASH_CASES) + len(FLASH_FULL)
    out["fully_masked_rows_zero"] = True
    out["tolerance_bf16"] = {"atol": ATTN_ATOL, "rtol": ATTN_RTOL}
    out["tolerance_f32"] = {"atol": F32_ATOL, "rtol": F32_RTOL}
    return out


#: (B, T, D): a long and a one-step sequence at recurrentgemma-9b's width,
#: its 2,000-token prompt, a ragged last slab (D 100) and rows that are
#: not 16-byte aligned (D 37: the kernel's staged loads)
RGLRU_CASES = ((2, 4096, 4096), (2, 1, 4096), (1, 2000, 4096), (3, 17, 100),
               (3, 300, 100), (2, 65, 37))


def check_rglru(torch, rg, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {"f32_bit_exact": True, "bf16_bit_exact": True}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for b, t, d in RGLRU_CASES:
            x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
            a = torch.rand((b, t, d), generator=gen, device=dev).to(dtype)
            h, hf = rg.rglru_scan(x, a)
            h2, hf2 = rg.rglru_scan_plain(x, a)
            for name, got, want in (("h", h, h2), ("h_final", hf, hf2)):
                equal = got.dtype == want.dtype and torch.equal(got, want)
                ok, err = _close(torch, got, want, 2e-2, 2e-2)
                # float32 must be bit-equal; bf16 h within one rounding
                if got.dtype != want.dtype \
                        or not (equal if dtype == torch.float32 else ok):
                    raise AssertionError(f"rglru {tag} [{b}, {t}, {d}] "
                                         f"{name}: {got.dtype}, max err {err}")
                key = f"{tag}_{name}_max_abs_err"
                out[key] = max(out.get(key, 0.0), err)
                out[f"{tag}_bit_exact"] &= bool(equal)
    torch.cuda.synchronize()
    out.update(cases=2 * len(RGLRU_CASES),
               tolerance_f32="equal", tolerance_bf16={"atol": 2e-2,
                                                      "rtol": 2e-2})
    return out


#: (B, H, T, K, V, scale of r/k/v, scale of u, decays, layout): the JAX
#: kernel tests' shapes, then rwkv6-7b's heads at ragged T for one and
#: three rows ("model": the init's w0 = -6 plus N(0, 0.01^2), w ~ 0.9975,
#: and the state grows over T; "jax": exp(-exp(N(0, 1)))), then V 16 (one
#: 16-wide block of channels a CTA) and K != V.  "btk" passes [B, H, T, K]
#: views of [B, T, H, K] tensors, as the model does.
WKV_CASES = tuple(
    [(1, 1, 32, 16, 16, 0.5, 0.3, "jax", "bhtk"),
     (2, 2, 64, 32, 32, 0.5, 0.3, "jax", "bhtk"),
     (1, 4, 128, 64, 64, 0.5, 0.3, "jax", "bhtk")]
    + [(b, 64, t, 64, 64, 1.0, 0.1, decay, "btk")
       for b in (1, 3) for t in (1, 7, 128, 400, 2000)
       for decay in ("model", "jax")]
    + [(3, 64, 130, 64, 16, 1.0, 0.1, "model", "btk"),
       (2, 4, 45, 16, 64, 0.5, 0.3, "jax", "btk")])


def _wkv_inputs(torch, gen, dev, b, h, t, kk, vv, scale, u_scale, decay,
                layout, dtype):
    def shape(n):
        return (b, t, h, n) if layout == "btk" else (b, h, t, n)

    def normal(n, std):
        return torch.randn(shape(n), generator=gen, device=dev) * std

    r, k = (normal(kk, scale).to(dtype) for _ in range(2))
    v = normal(vv, scale).to(dtype)
    logw = normal(kk, 0.01) - 6.0 if decay == "model" else normal(kk, 1.0)
    w = torch.exp(-torch.exp(logw))
    u = torch.randn((h, kk), generator=gen, device=dev) * u_scale
    if layout == "btk":
        r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))
    return r, k, v, w, u


def check_rwkv(torch, rw, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        worst = o_max = 0.0
        for case in WKV_CASES:
            r, k, v, w, u = _wkv_inputs(torch, gen, dev, *case, dtype)
            o, s = rw.rwkv6_scan(r, k, v, w, u)
            o2, s2 = rw.rwkv6_scan_plain(r, k, v, w, u)
            err = float((o.float() - o2.float()).abs().max())
            if o.dtype != dtype or s.dtype != torch.float32 \
                    or not torch.equal(s, s2) or not torch.equal(o, o2) \
                    or not bool(torch.isfinite(o).all()):
                raise AssertionError(
                    f"wkv {tag} {case}: not bit-equal: state max err "
                    f"{float((s - s2).abs().max())}, o max err {err}")
            worst = max(worst, err)
            o_max = max(o_max, float(o2.float().abs().max()))
        out[f"{tag}_o_max_abs_err"] = worst
        out[f"{tag}_max_abs_o"] = o_max
    torch.cuda.synchronize()
    out.update(cases=2 * len(WKV_CASES), state_bit_exact=True,
               o_bit_exact=True, tolerance={"o_and_state": "equal"})
    return out


# -- model -------------------------------------------------------------------


def _margin(logits) -> float:
    top = logits.float().topk(2, dim=-1).values
    return float(top[..., 0] - top[..., 1])


def last_logits(torch, model, params, seq, dev):
    """The model's logits after consuming ``seq`` from an empty cache,
    prefilled in 32-token chunks through a private pool."""
    n = len(seq)
    nblk = -(-n // BS)
    pool = model.init_paged_pool(nblk + 1, BS, dev)
    table = torch.arange(1, nblk + 1, dtype=torch.int32, device=dev)[None]
    for s in range(0, n, 32):
        chunk = seq[s:s + 32]
        toks = torch.tensor([chunk], dtype=torch.int32, device=dev)
        pos = torch.arange(s, s + len(chunk), dtype=torch.int32,
                           device=dev)[None]
        last = torch.tensor([len(chunk) - 1], dtype=torch.int32, device=dev)
        logits, pool = model.paged_step(params, toks, pool, table, pos, last)
    return logits[0]


def check_model(torch, dev, state):
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    engine = Engine(cfg, ServeConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = engine.params
    plain = DecoderLM(dataclasses.replace(cfg, attention_impl="reference"))
    info = {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "init_s": init_s,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
            "logit_tol": LOGIT_TOL, "split_margin": SPLIT_MARGIN,
            "max_splits": MAX_SPLITS}
    info.update(_hold_step_logits(torch, _step_logits(
        torch, cfg, params, {"kernel": engine.model, "plain": plain}, dev,
        SEED + 2), LOGIT_TOL))
    state.update(engine=engine, plain_model=plain)
    return info


def _step_logits(torch, cfg, params, models, dev, seed):
    """Logits of a mixed step and of the decode step after it, for each of
    ``models`` (name: model) on ``params``, from one seeded draw of
    tokens."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, c, m = 8, 32, 4
    tables = (torch.arange(b * m, device=dev, dtype=torch.int32)
              .reshape(b, m) + 1)
    # mixed step: rows 0-3 prefill a full chunk, rows 4-5 a 20-token
    # chunk (padding routed to the null block), rows 6-7 decode one token
    toks = torch.randint(0, cfg.vocab_size, (b, c), generator=gen,
                         device=dev, dtype=torch.int32)
    adv = torch.tensor([32, 32, 32, 32, 20, 20, 1, 1], device=dev)
    pos = torch.minimum(torch.arange(c, device=dev)[None], adv[:, None] - 1)
    pos = pos.to(torch.int32)
    last = (adv - 1).to(torch.int32)
    dec_toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                             device=dev, dtype=torch.int32)
    dec_pos = adv[:, None].to(torch.int32)
    out = {}
    for name, model in models.items():
        pool = model.init_paged_pool(b * m + 1, BS, dev)
        mixed, pool = model.paged_step(params, toks, pool, tables, pos, last)
        dec, pool = model.paged_step(params, dec_toks, pool, tables, dec_pos,
                                     torch.zeros(b, dtype=torch.int32,
                                                 device=dev))
        out[name] = (mixed.float(), dec.float())
    return out


def _hold_step_logits(torch, logits, tol):
    """The kernel path's step logits against the plain path's: finite,
    within ``tol``, and an argmax split only where the plain top-2 margin
    is within SPLIT_MARGIN, at most MAX_SPLITS times."""
    info, splits = {}, 0
    for i, step in enumerate(("mixed", "decode")):
        a, r = logits["kernel"][i], logits["plain"][i]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{step} step: non-finite logits")
        err = float((a - r).abs().max())
        info[f"{step}_max_abs_logit_diff"] = err
        info[f"{step}_max_abs_logit"] = float(r.abs().max())
        if err > tol:
            raise AssertionError(f"{step} step logits differ by {err} "
                                 f"(limit {tol})")
        for row in range(a.shape[0]):
            if int(a[row].argmax()) != int(r[row].argmax()):
                margin = _margin(r[row])
                if margin > SPLIT_MARGIN:
                    raise AssertionError(
                        f"{step} step row {row}: argmax split at margin "
                        f"{margin}")
                splits += 1
    if splits > MAX_SPLITS:
        raise AssertionError(f"{splits} argmax splits (limit {MAX_SPLITS})")
    info["argmax_splits_within_tolerance"] = splits
    return info


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# -- the main path -----------------------------------------------------------


def _prompts(vocab: int):
    """Prompt rows for the serve phase (numpy, seeded): lengths across
    16-400; three share a 64-token system prompt (prefix-cache hits, and
    a block-aligned hit that copies on write); one repeats an 8-token
    motif (the n-gram drafter's case)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    system = rng.integers(0, vocab, 64)
    rows = []
    for i, n in enumerate(PROMPT_LENS):
        row = rng.integers(0, vocab, n)
        if i in (2, 4, 6):
            row[:64] = system
        if i == 5:
            row = np.resize(rng.integers(0, vocab, 8), n)
        rows.append(row.astype(np.int64))
    return rows


def _drive(impl, requests):
    """All requests at once from client threads (they batch together)."""
    with cf.ThreadPoolExecutor(len(requests)) as ex:
        futs = [ex.submit(impl.infer, page, max_new_tokens=n)
                for page, n in requests]
        return [f.result(timeout=600) for f in futs]


def serve(torch, bd, pa, dev, state):
    """qwen2-1.5b at full width on the paged path (``_serve_wave``)."""
    info, toks = _serve_wave(torch, bd, pa, dev, state["engine"])
    state["launches"] = info["launches"]
    state["serve_tokens"] = toks[:len(PROMPT_LENS)]
    state["serve_tokens_per_s"] = info["tokens_per_s"]
    return info


def _serve_wave(torch, bd, pa, dev, engine):
    """The serve traffic through ``engine``'s paged path: the nine prompt
    pages x NEW_TOKENS at once, then a one-token follow-up of the first,
    through ``InferenceImpl.infer`` under the default ServeConfig.  Fails
    unless the three kernels of the path launched, the scheduler took its
    mixed, spec-verify, prefix-hit and copy-on-write paths, and the greedy
    tokens equal a replay through the plain versions under the split rule.
    Returns (info, token arrays)."""
    import numpy as np
    from repro_torch.serving import (Engine, InferenceImpl, ServeConfig,
                                     decode_token_page, encode_prompt_page)

    cfg = engine.cfg
    widths = []   # (step width, seconds) of every model step in the run
    for name in ("paged_step", "paged_step_verify"):
        fn = getattr(engine.model, name)

        def run(params, tokens, *args, _fn=fn):
            t0 = time.perf_counter()
            out = _fn(params, tokens, *args)
            torch.cuda.synchronize()   # the batcher syncs here anyway
            widths.append((int(tokens.shape[1]), time.perf_counter() - t0))
            return out
        setattr(engine.model, name, run)
    prompts = _prompts(cfg.vocab_size)
    # the wave, then a one-token follow-up of the first prompt: its only
    # generation step has no draft budget, so it is a plain decode step
    # (T == 1), and it re-reads a cached prefix block it must copy on write
    wave = [(encode_prompt_page(p[None]), NEW_TOKENS) for p in prompts]
    follow = [(encode_prompt_page(prompts[0][None]), 1)]
    impl = InferenceImpl(engine)
    counters = (bd.decode_columns, bd.decode_column, pa.paged_attention,
                pa.paged_prefill_attention)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = _drive(impl, wave) + _drive(impl, follow)
    wall = time.perf_counter() - t0
    launches = {f"{fn.__module__.split('.')[-1]}.{fn.__name__}": fn.launches
                for fn in counters}
    stats = impl.batcher.collect_stats()
    impl.close()
    on_path = ("bebop_decode.decode_columns", "paged_attention.paged_attention",
               "paged_attention.paged_prefill_attention")
    missing = [k for k in on_path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({launches})")
    missed = [k for k in ("prefix_hits", "cow_copies", "spec_steps",
                          "mixed_steps") if stats[k] <= 0]
    if missed:
        raise AssertionError(f"scheduler paths not taken: {missed} ({stats})")
    toks = [decode_token_page(r["page"]) for r in out]
    for r, t, (_, n) in zip(out, toks, wave + follow):
        if r["batch"] != 1 or r["new_tokens"] != n or t.shape != (1, n) \
                or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"bad response {r['batch']}x"
                                 f"{r['new_tokens']} for {n} tokens")
    # replay through the plain attention, called by name via the config
    ref = Engine(dataclasses.replace(cfg, attention_impl="reference"),
                 ServeConfig(), params=engine.params, device=dev)
    ref_impl = InferenceImpl(ref)
    ref_out = _drive(ref_impl, wave) + _drive(ref_impl, follow)
    ref_impl.close()
    splits, worst = 0, None
    for prompt, a, r in zip(prompts + prompts[:1], toks,
                            [decode_token_page(o["page"]) for o in ref_out]):
        if np.array_equal(a, r):
            continue
        j = int(np.nonzero(a[0] != r[0])[0][0])
        seq = [int(x) for x in prompt] + [int(x) for x in r[0, :j]]
        margin = _margin(last_logits(torch, ref.model, ref.params, seq, dev))
        if margin > SPLIT_MARGIN:
            raise AssertionError(f"token split at output {j} with "
                                 f"reference margin {margin}")
        splits += 1
        worst = margin if worst is None else max(worst, margin)
    if splits > MAX_SPLITS:
        raise AssertionError(f"{splits} requests split from the plain "
                             f"replay (limit {MAX_SPLITS})")
    by_width = {}
    for w, s in widths:
        by_width.setdefault(w, []).append(s * 1e3)
    n_tokens = sum(r["new_tokens"] for r in out)
    return {"requests": len(out), "tokens_out": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "launches": launches,
            "steps": len(widths),
            "step_ms_by_width": {
                str(w): {"steps": len(v), "mean_ms": sum(v) / len(v),
                         "max_ms": max(v)} for w, v in sorted(by_width.items())},
            "stats": stats, "tokens_vs_plain": {
                "tokens_checked": n_tokens, "splits_within_tolerance": splits,
                "largest_split_margin": worst, "split_margin": SPLIT_MARGIN,
                "max_splits": MAX_SPLITS}}, toks


def profile(torch, dev, state):
    """Device busy and idle share over a short serve window (4 requests x
    8 new tokens, after a warm-up of 4 others), from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from repro_torch.serving import InferenceImpl, encode_prompt_page
    engine = state["engine"]
    prompts = _prompts(engine.cfg.vocab_size)
    calls = []
    for name in ("paged_step", "paged_step_verify"):
        fn = getattr(engine.model, name)
        setattr(engine.model, name,
                lambda *a, _fn=fn: calls.append(1) or _fn(*a))
    impl = InferenceImpl(engine)
    _drive(impl, [(encode_prompt_page(p[None]), 8) for p in prompts[4:8]])
    reqs = [(encode_prompt_page(p[None]), 8) for p in prompts[:4]]
    calls.clear()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _drive(impl, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = len(calls)
    impl.close()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    top = {}
    for e in dev_events:
        top[e.name[:60]] = top.get(e.name[:60], 0.0) \
            + e.time_range.elapsed_us() / 1e3
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if dev_events else None,
            "device_idle_share": (1 - busy_ms / (wall * 1e3))
            if dev_events else None,
            "device_ops": len(dev_events), "steps": steps,
            "device_ops_per_step": len(dev_events) / max(steps, 1),
            "top_device_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:8])}


# -- the RPC front door ----------------------------------------------------------

# Sampled tokens against the plain replay.  A sampled token is the inverse
# CDF of the filtered distribution at a seeded uniform (serving/sampling.py),
# so the kernel path and the plain replay draw different tokens only where
# an edge of the CDF moved past the uniform.  An edge m moves by
# sum_{i<=m} p_i (dx_i - E_p[dx]) / T when the logits move by dx, and the
# walk runs in vocabulary order, so a shift of one likely token's mass
# moves the intervals of every token after it.  On an H100 the largest
# distance between the two paths' top-k 40 CDFs at T 0.8 was 0.020 over
# one candidate's 8 prefixes (the logits differ by up to 0.071, PERF.md
# section 2, and the random-weight model puts much of the mass on one
# token); SAMPLE_EPS is twice that, as LOGIT_TOL is twice the largest
# logit difference.  Such shifts make splits common (on that card all 6
# candidates of the two n = 3 requests split from a free-running replay
# within 2 tokens), so each token is checked on its own prefix (teacher
# forcing).  Those checks found 2 and 3 splits in 24 sampled tokens, each
# uniform 0.003-0.009 from the kernel token's replay interval (PERF.md);
# MAX_SAMPLED_SPLITS is twice the larger count.
SAMPLE_EPS = 0.04
MAX_SAMPLED_SPLITS = 6                # per 24 sampled tokens
SAMPLE_GEN = dict(temperature=0.8, top_k=40, seed=1234)     # Generate, n 3
SAMPLE_SPEC = dict(temperature=0.5, top_k=3, seed=77)       # Infer, spec on
SAMPLE_TOP_P = dict(temperature=0.8, top_p=0.9, seed=5)     # step timing
RPC_NEW = 16
# preemption through the server: a 1,000-token prompt (context past 1,024
# keys) and a 300-token one at priority 0 fill a pool of 98 usable blocks
# (69 + 21 of them), then a 200-token prompt at priority 1 pages the larger
# one out to host; it resumes once the 300-token one finishes
SWAP_LENS, SWAP_NEW, SWAP_BLOCKS = (1000, 300, 200), (100, 32, 32), 99


def _gate(batcher):
    """Hold ``batcher``'s admission until :func:`_release`, so a wave sent
    from many client threads is admitted as one, in a canonical order:
    two runs then schedule alike, step for step."""
    import threading
    gate = threading.Event()
    admit = batcher._admit

    def gated():
        gate.wait()
        return admit()
    batcher._admit = gated
    return gate


def _release(batcher, gate, order, n, timeout=120.0):
    """Wait until ``n`` requests are queued, sort the queue by ``order``
    (a key of the prompt tokens) and open the gate."""
    import collections
    end = time.monotonic() + timeout
    while True:
        with batcher._cond:
            if len(batcher._queue) >= n:
                batcher._queue = collections.deque(sorted(
                    batcher._queue, key=lambda p: order(p.tokens)))
                break
        if time.monotonic() > end:
            raise AssertionError(f"{len(batcher._queue)} of {n} requests "
                                 f"queued")
        time.sleep(0.002)
    gate.set()


def _wave(impl, call, requests, gated=True):
    """Send every request from its own client thread, through the gate
    unless ``gated`` is false (then the batcher admits them as they come);
    returns (responses, per-request wall seconds, wave wall seconds)."""
    import numpy as np
    from repro_torch.serving import decode_token_page
    keys = {decode_token_page(page).astype(np.int32).tobytes(): i
            for i, (page, _kw) in enumerate(requests)}
    gate = _gate(impl.batcher) if gated else None

    def one(req):
        t0 = time.perf_counter()
        out = call(*req)
        return out, time.perf_counter() - t0
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(requests)) as ex:
        futs = [ex.submit(one, r) for r in requests]
        if gated:
            _release(impl.batcher, gate, lambda t: keys.get(
                np.asarray(t, np.int32).tobytes(), -1), len(requests))
        res = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    if gated:
        del impl.batcher._admit          # the class's again
    return [r for r, _ in res], [s for _, s in res], wall


def _step_timer(torch, batcher, steps):
    """Record the seconds of every scheduler step (device step, logits to
    the host and the token picks) in ``steps``."""
    step = batcher._step

    def timed():
        t0 = time.perf_counter()
        step()
        steps.append(time.perf_counter() - t0)
    batcher._step = timed


def _probs_after(torch, eng, seq, sp):
    """``eng``'s filtered sampling distribution after ``seq`` (float64
    [V]), from a dense prefill."""
    from repro_torch.serving import sampling
    toks = torch.tensor([list(seq)], dtype=torch.int32, device=eng.device)
    logits, _ = eng.model.prefill(eng.params, {"tokens": toks}, len(seq))
    return sampling.target_probs(logits[0].float().cpu().numpy()[None],
                                 sp)[0]


def _interval_dist(probs, tok, u):
    """How far the uniform ``u`` lies from the interval of ``tok`` in the
    inverse-CDF walk over ``probs`` (0 inside it)."""
    import numpy as np
    hi = float(np.cumsum(probs)[tok])
    lo = hi - float(probs[tok])
    return 0.0 if lo <= u < hi else min(abs(u - lo), abs(u - hi))


def _forced_sampled(torch, ref, prompt, toks, sp, what):
    """Every sampled token of ``toks`` ([n, T]: row r is candidate r)
    against the plain replay ``ref`` on the row's own prefix (teacher
    forcing, so one split does not end a row's comparison).  At index j
    the replay draws from its filtered distribution at the schedule's
    uniform; where it picks another token, the split is legitimate only
    if that uniform lies within SAMPLE_EPS of the kernel token's interval
    in the replay's CDF, and there may be at most MAX_SAMPLED_SPLITS such
    splits in 24 tokens."""
    from repro_torch.serving import sampling
    dists = []
    for row in range(toks.shape[0]):
        for j in range(toks.shape[1]):
            seq = [int(x) for x in prompt] + [int(x) for x in toks[row, :j]]
            pr = _probs_after(torch, ref, seq, sp)
            u = float(sampling._uniform_at(sp.seed, j, 1, row)[0, 0])
            k = int(toks[row, j])
            if sampling._inverse_cdf(pr, u) == k:
                continue
            dists.append(_interval_dist(pr, k, u))
            if dists[-1] > SAMPLE_EPS:
                raise AssertionError(
                    f"{what}: candidate {row} index {j} drew {k}; the "
                    f"replay's interval of it is {dists[-1]} from the "
                    f"uniform {u} (limit {SAMPLE_EPS})")
    limit = MAX_SAMPLED_SPLITS * toks.size / 24
    if len(dists) > limit:
        raise AssertionError(f"{what}: {len(dists)} splits in {toks.size} "
                             f"tokens (limit {limit:g})")
    return {"tokens_checked": int(toks.size),
            "splits_within_tolerance": len(dists), "split_limit": limit,
            "split_interval_distances": dists}


def _spec_edges(probs):
    """Where a speculative decision at one index flips, as a function of
    its two uniforms: the accept test compares ``u[0]`` with p(draft),
    the bonus draw walks the CDF with ``u[0]``, a residual resample walks
    the residual CDF (p with the draft zeroed) with ``u[1]``."""
    import numpy as np
    kept = np.nonzero(probs > 0)[0]
    e0 = np.concatenate([np.cumsum(probs)[kept], probs[kept]])
    e1 = []
    for d in kept:
        resid = probs.copy()
        resid[d] = 0.0
        if resid.sum() > 1e-12:
            e1 += list(np.cumsum(resid / resid.sum())[kept[kept != d]])
    return e0, np.asarray(e1)


def _spec_match(torch, ref, prompt, got, want, sp, what):
    """A sampled request served with spec decode against the plain replay
    with the same ServeConfig (free running: its drafts and accept tests
    are part of the stream): equal, or the first split lies where one of
    the replay's uniforms at that index is within SAMPLE_EPS of one of
    its decision edges (the row is compared only up to it)."""
    import numpy as np
    from repro_torch.serving import sampling
    out = {"tokens_checked": 0, "splits_within_tolerance": 0}
    for row in range(got.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size == 0:
            out["tokens_checked"] += got.shape[1]
            continue
        j = int(diff[0])
        out["tokens_checked"] += j
        seq = [int(x) for x in prompt] + [int(x) for x in want[row, :j]]
        e0, e1 = _spec_edges(_probs_after(torch, ref, seq, sp))
        u = sampling._uniform_at(sp.seed, j, 1, row)[0]
        dist = min(float(np.abs(e0 - u[0]).min()),
                   float(np.abs(e1 - u[1]).min()) if e1.size
                   else float("inf"))
        if dist > SAMPLE_EPS:
            raise AssertionError(f"{what}: split at output {j}, uniforms "
                                 f"{u.tolist()} {dist} from the replay's "
                                 f"nearest decision edge")
        out["splits_within_tolerance"] += 1
        out["split_edge_distance"] = dist
    return out


def _rpc_host_us(service, wire, req, resp, calls=200):
    """The RPC layer's host time for one Infer round trip, without the
    handler: the client's request encode, the server's request decode and
    response encode, the client's response decode, and the frames."""
    from repro_torch.core.rpc import Flags, Frame, FrameReader, encode_frame
    t0 = time.perf_counter()
    for _ in range(calls):
        body = wire.encode(service.InferRequest, req)
        reader = FrameReader()
        frame, = reader.feed(encode_frame(Frame(1, body, Flags.END_STREAM)))
        wire.decode(service.InferRequest, frame.payload)
        out = wire.encode(service.InferResponse, resp)
        frame, = reader.feed(encode_frame(Frame(1, out, Flags.END_STREAM)))
        wire.decode(service.InferResponse, frame.payload)
    return (time.perf_counter() - t0) / calls * 1e6


def _host_probs_ms(sampling, vocab, calls=5):
    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    logits = (rng.standard_normal((1, vocab)) * 0.78).astype(np.float32)
    out = {}
    for name, kw in (("top_k_40", SAMPLE_GEN), ("top_p_0.9", SAMPLE_TOP_P)):
        sp = sampling.SamplingParams(**kw)
        t0 = time.perf_counter()
        for _ in range(calls):
            sampling._host_probs(logits, sp)
        out[name] = (time.perf_counter() - t0) / calls * 1e3
    return out


def rpc_serve(torch, bd, pa, dev, state):
    """The port's Bebop RPC server (``build_server`` + ``listen_tcp``)
    driven over TCP by the port's ``Channel``: the nine serve prompts by
    ``Infer`` (page bytes equal to ``InferenceImpl.infer``'s in process),
    sampled waves, a seeded ``Generate`` with n = 3, a sampled ``Infer``
    with spec decode, ``InferStream``, an ``Infer`` -> ``ScorePage`` batch,
    ``Stats`` and ``Health``; a second server whose small pool preempts
    and swaps a request past 1,024 keys; and the launcher's ``--once``
    probe as a subprocess."""
    import numpy as np
    from repro_torch.core import wire
    from repro_torch.core.rpc import Channel, Status, TcpTransport
    from repro_torch.serving import (Engine, InferenceImpl, SamplingParams,
                                     ServeConfig, build_server,
                                     decode_token_page, encode_prompt_page,
                                     sampling, service)

    engine = state["engine"]
    cfg = engine.cfg
    ref = Engine(dataclasses.replace(cfg, attention_impl="reference"),
                 ServeConfig(), params=engine.params, device=dev)
    prompts = _prompts(cfg.vocab_size)
    pages = [encode_prompt_page(p[None]) for p in prompts]
    counters = (bd.decode_columns, pa.paged_attention,
                pa.paged_prefill_attention)
    for fn in counters:
        fn.launches = 0
    info = {}

    def local_wave(kw, steps):
        """The nine prompts by ``InferenceImpl.infer`` in process."""
        local = InferenceImpl(engine)
        _step_timer(torch, local.batcher, steps)
        try:
            return _wave(local, lambda page, k: local.infer(page, **k),
                         [(p, {"max_new_tokens": RPC_NEW, **kw})
                          for p in pages])
        finally:
            local.close()

    def tcp_wave(kw, steps, gated=True):
        """The nine prompts by ``Infer`` over TCP, one connection each, to
        a fresh server (a fresh batcher: no prefix cache carried over)."""
        wimpl = InferenceImpl(engine)
        _step_timer(torch, wimpl.batcher, steps)
        wserver = build_server(engine, impl=wimpl)
        whost, wport, _ = wserver.listen_tcp()
        clients = queue.Queue()
        chs = [Channel(TcpTransport.connect(whost, wport)) for _ in pages]
        for ch in chs:
            clients.put(ch.typed(service.InferenceService))

        def rpc_infer(page, k):
            inf = clients.get()
            try:
                return inf.Infer({"page": page, **k})
            finally:
                clients.put(inf)
        try:
            return _wave(wimpl, rpc_infer,
                         [(p, {"max_new_tokens": RPC_NEW, **kw})
                          for p in pages], gated)
        finally:
            for ch in chs:
                ch.close()
            wserver.drain(timeout=30)
            wimpl.close()

    def summary(runs, steps):
        n_tok = sum(int(o["new_tokens"]) for o in runs[0][0])
        lat = np.concatenate([np.asarray(s) for _, s, _ in runs]) * 1e3
        return {"tokens_per_s": [n_tok / w for _, _, w in runs],
                "request_ms_p50": float(np.percentile(lat, 50)),
                "request_ms_p95": float(np.percentile(lat, 95)),
                "step_ms_mean": 1e3 * sum(steps) / len(steps),
                "steps": len(steps)}

    # greedy: in process, TCP, TCP, in process (the spread of each); every
    # wave is admitted as one, in one order, so all four give the same
    # bytes as the first in-process wave
    runs = {"inprocess": [], "tcp": []}
    steps = {"inprocess": [], "tcp": []}
    for kind in ("inprocess", "tcp", "tcp", "inprocess"):
        fn = local_wave if kind == "inprocess" else tcp_wave
        runs[kind].append(fn({}, steps[kind]))
    want = [o["page"] for o in runs["inprocess"][0][0]]
    for kind, rs in runs.items():
        for out, _, _ in rs:
            for i, (o, w) in enumerate(zip(out, want)):
                if bytes(bytearray(o["page"])) != w:
                    raise AssertionError(f"prompt {i}: a {kind} wave's page "
                                         f"differs from InferenceImpl.infer's")
    # and once over TCP as clients send it: admitted as the requests come
    # (another batch composition, so its pages are held only to their shape)
    st = []
    run = tcp_wave({}, st, gated=False)
    if any(decode_token_page(bytes(bytearray(o["page"]))).shape
           != (1, RPC_NEW) for o in run[0]):
        raise AssertionError("ungated wave: bad pages")
    info["greedy_wave"] = {
        "requests": len(pages), "new_tokens": RPC_NEW,
        "pages_equal_inprocess": True,
        "serve_phase_tokens_per_s": state.get("serve_tokens_per_s"),
        **{k: summary(runs[k], steps[k]) for k in runs},
        "tcp_ungated": summary([run], st)}

    # sampled waves over TCP: the same prompts, top-k 40, then top-p 0.9
    for name, kw in (("top_k_40", SAMPLE_GEN), ("top_p_0.9", SAMPLE_TOP_P)):
        st = []
        run = tcp_wave(kw, st)
        toks = [decode_token_page(bytes(bytearray(o["page"])))
                for o in run[0]]
        if any(t.shape != (1, RPC_NEW) or int(t.max()) >= cfg.vocab_size
               for t in toks):
            raise AssertionError(f"sampled wave {name}: bad pages")
        info[f"sampled_wave_{name}"] = summary([run], st)

    impl = InferenceImpl(engine)
    server = build_server(engine, impl=impl)
    host, port, _ = server.listen_tcp()
    chans = []

    def typed():
        ch = Channel(TcpTransport.connect(host, port))
        chans.append(ch)
        return ch.typed(service.InferenceService)

    try:
        inf = typed()
        # seeded Generate, n = 3, top-k 40, each token against the plain
        # replay on its own prefix
        sp = SamplingParams(**SAMPLE_GEN)
        gp = prompts[1]
        gen = inf.Generate({"tokens": gp.astype(np.uint32), "batch": 1,
                            "seq_len": len(gp), "max_new_tokens": 8, "n": 3,
                            **SAMPLE_GEN})
        gtok = np.asarray(gen["tokens"]).reshape(3, -1).astype(np.int64)
        if gtok.shape != (3, 8) or len({tuple(r) for r in gtok}) < 2:
            raise AssertionError(f"n=3 candidates: {gtok}")
        info["generate_n3"] = {**_forced_sampled(
            torch, ref, gp, gtok, sp, "Generate n=3"),
            "sampling": SAMPLE_GEN}
        # the same request as a paged Infer: one prefill forked into three
        # candidates over shared prompt blocks
        before = impl.batcher.collect_stats()
        fres = inf.Infer({"page": pages[1], "max_new_tokens": 8, "n": 3,
                          **SAMPLE_GEN})
        forks = impl.batcher.collect_stats()["forks"] - before["forks"]
        ftok = decode_token_page(bytes(bytearray(fres["page"]))).astype(
            np.int64)
        if forks != 2 or ftok.shape != (3, 8):
            raise AssertionError(f"n=3 Infer: forks {forks}, {ftok.shape}")
        info["infer_n3_fork"] = {"forks": forks, **_forced_sampled(
            torch, ref, gp, ftok, sp, "Infer n=3 fork")}

        # sampled Infer with spec decode on, against the plain replay with
        # the same ServeConfig (spec decode on too)
        sp = SamplingParams(**SAMPLE_SPEC)
        before = impl.batcher.collect_stats()
        sres = inf.Infer({"page": pages[5], "max_new_tokens": 24,
                          **SAMPLE_SPEC})
        after = impl.batcher.collect_stats()
        ref_impl = InferenceImpl(ref)
        rres = ref_impl.infer(pages[5], max_new_tokens=24, **SAMPLE_SPEC)
        rstats = ref_impl.batcher.collect_stats()
        ref_impl.close()
        stok = decode_token_page(bytes(bytearray(sres["page"]))).astype(
            np.int64)
        rtok = decode_token_page(rres["page"]).astype(np.int64)
        spec = {k: after[k] - before[k] for k in
                ("spec_steps", "spec_proposed", "spec_accepted",
                 "spec_resamples", "sampled_requests")}
        m = _spec_match(torch, ref, prompts[5], stok, rtok, sp,
                        "spec Infer vs plain replay")
        if spec["spec_steps"] <= 0:
            raise AssertionError(f"sampled Infer ran no verify step: {spec}")
        if not m["splits_within_tolerance"] \
                and spec["spec_resamples"] != rstats["spec_resamples"]:
            raise AssertionError(f"spec_resamples {spec} vs replay "
                                 f"{rstats['spec_resamples']}")
        info["spec_infer"] = {**m, "stats": spec,
                              "replay_spec_resamples":
                              rstats["spec_resamples"],
                              "sampling": SAMPLE_SPEC}

        # InferStream: chunks joined equal the dense engine's tokens (the
        # stream runs Engine.generate) and the paged Infer page
        chunks = list(inf.InferStream({"page": pages[0],
                                       "max_new_tokens": RPC_NEW}))
        joined = np.concatenate([decode_token_page(bytes(bytearray(
            c["page"]))) for c in chunks], axis=1)
        dense = engine.generate(prompts[0][None], max_new_tokens=RPC_NEW)
        if [c["index"] for c in chunks] != list(range(RPC_NEW)) \
                or not np.array_equal(joined, dense):
            raise AssertionError("InferStream chunks differ from "
                                 "Engine.generate")
        info["infer_stream"] = {
            "chunks": len(chunks),
            "vs_infer_page": _match(
                torch, ref, [prompts[0][None]], [joined.astype(np.int64)],
                [decode_token_page(want[0]).astype(np.int64)],
                "InferStream vs Infer")}

        # Infer -> ScorePage in one batch, against two calls
        iid = service.InferenceService.method("Infer").id
        sid = service.InferenceService.method("ScorePage").id
        req = {"page": pages[3], "max_new_tokens": 8}
        ch = chans[-1]
        t0 = time.perf_counter()
        res = ch.batch([{"method_id": iid, "payload": wire.encode(
            service.InferRequest, req)}, {"method_id": sid,
                                          "input_from": 0}])
        batch_ms = (time.perf_counter() - t0) * 1e3
        if [r["status"] for r in res] != [Status.OK] * 2:
            raise AssertionError(f"batch statuses {res}")
        bscore = wire.decode(service.ScoreResponse,
                             res[1]["payload"])["scores"]
        page = bytes(bytearray(inf.Infer(req)["page"]))
        alone = inf.ScorePage({"page": page})["scores"]
        if not np.allclose(bscore, alone, atol=F32_ATOL, rtol=F32_RTOL) \
                or not np.isfinite(bscore).all():
            raise AssertionError(f"batched score {bscore} vs {alone}")
        info["infer_scorepage_batch"] = {"batch_ms": batch_ms,
                                         "score": float(bscore[0]),
                                         "separate_calls_score":
                                         float(alone[0])}

        st = inf.Stats({})
        names = st["names"].split("\n")
        health = inf.Health({"verbose": True})
        if not health["serving"] or health["draining"] \
                or "sampled_requests" not in names:
            raise AssertionError(f"Stats/Health: {health}")
        stats = dict(zip(names, np.asarray(st["values"]).tolist()))
        info["stats"] = {k: stats[k] for k in (
            "requests", "sampled_requests", "forks", "spec_steps",
            "spec_resamples", "decode_steps", "mixed_steps",
            "ingest_pages")}
        info["health"] = {"serving": bool(health["serving"]),
                          "inflight": int(health["inflight"])}
        info["rpc_host_us_per_infer"] = _rpc_host_us(
            service, wire, {"page": pages[8], "max_new_tokens": RPC_NEW},
            {"page": want[8], "batch": 1, "new_tokens": RPC_NEW})
        info["host_probs_ms"] = {"vocab": cfg.vocab_size, **_host_probs_ms(
            sampling, cfg.vocab_size)}
    finally:
        for ch in chans:
            ch.close()
        server.drain(timeout=30)
        impl.close()
    launches = {f"{fn.__module__.split('.')[-1]}.{fn.__name__}": fn.launches
                for fn in counters}
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels not launched through the server: "
                             f"{launches}")
    info["launches"] = launches
    info["preempt_swap"] = _rpc_preempt(torch, dev, engine, ref)
    info["launcher_once"] = _launcher_once(state["src"])
    return info


def _rpc_preempt(torch, dev, engine, ref):
    """A second server with a pool of SWAP_BLOCKS blocks at cache_len 2048:
    two priority-0 requests fill it, a priority-1 request pages the
    1,000-token one (context 1,100 keys) out to host, and it resumes; the
    tokens must equal the plain replay's under the greedy split rule."""
    import numpy as np
    from repro_torch.core.rpc import Channel, TcpTransport
    from repro_torch.serving import (Engine, InferenceImpl, ServeConfig,
                                     build_server, decode_token_page,
                                     encode_prompt_page, service)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, engine.cfg.vocab_size, n) for n in SWAP_LENS]
    sc = ServeConfig(cache_len=2048, num_blocks=SWAP_BLOCKS)
    small = Engine(engine.cfg, sc, params=engine.params, device=dev)
    impl = InferenceImpl(small)
    server = build_server(small, impl=impl)
    host, port, _ = server.listen_tcp()
    chans = [Channel(TcpTransport.connect(host, port)) for _ in prompts]
    try:
        def call(i, prio):
            inf = chans[i].typed(service.InferenceService)
            return inf.Infer({"page": encode_prompt_page(prompts[i][None]),
                              "max_new_tokens": SWAP_NEW[i],
                              "priority": prio})
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(3) as ex:
            low = [ex.submit(call, i, 0) for i in (0, 1)]
            end = time.monotonic() + 120
            while impl.batcher.collect_stats()["active_requests"] < 2:
                if time.monotonic() > end:
                    raise AssertionError("low-priority requests not active")
                time.sleep(0.005)
            high = ex.submit(call, 2, 1)
            out = [f.result(timeout=600) for f in low + [high]]
        wall = time.perf_counter() - t0
        stats = impl.batcher.collect_stats()
    finally:
        for ch in chans:
            ch.close()
        server.drain(timeout=30)
        impl.close()
    if stats["preemptions"] < 1 or stats["swap_ins"] < 1:
        raise AssertionError(f"no preemption/swap: {stats}")
    got = [decode_token_page(bytes(bytearray(o["page"]))).astype(np.int64)
           for o in out]
    want = [ref.generate(p[None], max_new_tokens=n).astype(np.int64)
            for p, n in zip(prompts, SWAP_NEW)]
    return {"wall_s": wall, "preemptions": stats["preemptions"],
            "swap_ins": stats["swap_ins"],
            "swapped_blocks": stats["swapped_blocks"],
            "longest_context": SWAP_LENS[0] + SWAP_NEW[0],
            "tokens_vs_plain": _match(torch, ref, [p[None] for p in prompts],
                                      got, want, "preempted vs plain")}


def _launcher_once(src):
    """``python -m repro_torch.launch.serve --arch qwen2-1.5b --full
    --once`` as a subprocess, with ``src`` on its path: it must exit 0
    after its probe line."""
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "qwen2-1.5b", "--full", "--once"],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    probe = [ln for ln in out.stdout.splitlines()
             if ln.startswith("probe generated 4 tokens")]
    if out.returncode != 0 or not probe:
        raise AssertionError(f"launcher --once exited {out.returncode}: "
                             f"{out.stdout[-500:]} {out.stderr[-1500:]}")
    return {"exit_code": out.returncode, "seconds":
            time.perf_counter() - t0, "probe": probe[0],
            "serving_line": out.stdout.splitlines()[0]}


# -- gemma-2b on the paged path ------------------------------------------------

# gemma-2b's step logits, paged kernels against their plain versions.  Its
# logits have another scale than qwen2's (the embedding scaled by sqrt(2048)
# on the way in, the tied unembed over a 256,000-token vocabulary), so the
# limit is its own: the largest difference measured on an H100 was
# GEMMA_LOGIT_MEASURED, on logits of up to 11 in magnitude (PERF.md), and
# the limit is about twice that.
GEMMA_LOGIT_MEASURED = 0.082
GEMMA_LOGIT_TOL = 0.16


def gemma_serve(torch, bd, pa, dev, state):
    """gemma-2b at full width (18 layers, d_model 2048, 8 query heads over
    one KV head of 256, GeGLU, the tied embedding scaled by sqrt(d), vocab
    256,000, bf16) on the paged path: its step logits against the plain
    attention's, then the serve phase's traffic and checks
    (``_serve_wave``)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serving import Engine, ServeConfig
    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    engine = Engine(cfg, ServeConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    info = {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype, "init_s": init_s,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(engine.params)),
            "logit_tol": GEMMA_LOGIT_TOL,
            "logit_tol_from_measured": GEMMA_LOGIT_MEASURED}
    plain = DecoderLM(dataclasses.replace(cfg, attention_impl="reference"))
    info.update(_hold_step_logits(torch, _step_logits(
        torch, cfg, engine.params, {"kernel": engine.model, "plain": plain},
        dev, SEED + 12), GEMMA_LOGIT_TOL))
    wave, _ = _serve_wave(torch, bd, pa, dev, engine)
    state["gemma_launches"] = wave["launches"]
    del engine, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {**info, **wave}


# -- the replicated tier -------------------------------------------------------

#: one-way link latency of the slow replica in the hedging run (seconds):
#: longer than the hedge delay, so a hedge fires and the fast replica wins
HEDGE_LATENCY_S = 0.25
HEDGE_DELAY_MS = 50.0
FLEET_NEW = 16                       # new tokens of a fleet request
FLEET_STREAM_NEW = 32                # of the killed stream


def _tcp_wave(host, port, pages, new_tokens):
    """Every page by ``Infer`` over TCP at once, one connection each;
    returns (token arrays, per-request seconds, wave seconds)."""
    from repro_torch.core.rpc import Channel, TcpTransport
    from repro_torch.serving import decode_token_page, service

    def one(page):
        ch = Channel(TcpTransport.connect(host, port))
        try:
            t0 = time.perf_counter()
            res = ch.typed(service.InferenceService).Infer(
                {"page": page, "max_new_tokens": new_tokens}, timeout=600)
            sec = time.perf_counter() - t0
        finally:
            ch.close()
        return decode_token_page(bytes(bytearray(res["page"]))).astype(
            "int64"), sec
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(pages)) as ex:
        res = list(ex.map(one, pages))
    return [r for r, _ in res], [s for _, s in res], time.perf_counter() - t0


def _latency(secs):
    import numpy as np
    ms = np.asarray(secs) * 1e3
    return {"request_ms_p50": float(np.percentile(ms, 50)),
            "request_ms_p95": float(np.percentile(ms, 95))}


def _stream_tokens(ch, sid, raw, on_chunk=None):
    """An InferStream's chunks joined into one [1, n] token array."""
    import numpy as np
    from repro_torch.core import wire
    from repro_torch.serving import decode_token_page, service
    chunks = []
    for item in ch.call(sid, raw, server_stream=True, timeout=600):
        chunk = wire.decode(service.InferChunk, item.payload)
        chunks.append(decode_token_page(bytes(bytearray(chunk["page"]))))
        if on_chunk is not None:
            on_chunk(len(chunks))
    return np.concatenate(chunks, axis=1).astype(np.int64)


def _router_host_us(page, calls=300):
    """The router's own host time for one ``Infer``: the mean round trip
    through ``build_router_server`` to a replica that echoes the request
    page, less the mean round trip to that replica directly, both over
    in-memory transports (the proxy's decode of the affinity prefix, its
    pick, its keyed call and the extra hop's frames)."""
    from repro_torch.core import wire
    from repro_torch.core.rpc import Channel, Router, Server, connected_pair
    from repro_torch.serving import RouterConfig, build_router_server, service
    svc = service.InferenceService
    rt = Router()
    for name, fn in (("Infer", lambda req, ctx: {
            "page": req["page"], "batch": 1, "new_tokens": 0}),
            ("Health", lambda req, ctx: {"serving": True, "epoch": 1})):
        m = svc.method(name)
        rt.register_handler(m.id, fn, name=m.name, kind=m.kind,
                            request_type=m.request, response_type=m.response,
                            service=svc.name)
    echo = Server(rt)

    def dial(server):
        ct, st = connected_pair()
        server.serve_transport(st, blocking=False)
        return ct

    rserver, router = build_router_server(
        [lambda: dial(echo)], RouterConfig(health_interval_s=0, hedge=False))
    raw = wire.encode(service.InferRequest, {"page": page, "max_new_tokens": 16})
    mid = svc.method("Infer").id
    out = {}
    for name, server in (("direct", echo), ("router", rserver)):
        ch = Channel(dial(server))
        for _ in range(20):
            ch.call(mid, raw)
        t0 = time.perf_counter()
        for _ in range(calls):
            ch.call(mid, raw)
        out[f"{name}_us"] = (time.perf_counter() - t0) / calls * 1e6
        ch.close()
    router.close()
    out["router_host_us_per_infer"] = out["router_us"] - out["direct_us"]
    return out


def fleet_serve(torch, bd, pa, dev, state):
    """The replicated tier on the card.  In process: ``build_router_server``
    over two ``InProcessReplica``s of the full-width qwen2-1.5b (one
    engine, two batchers launching on one card) on TCP: the nine pages
    against one replica's; an ``InferStream`` whose replica is killed
    after 2 chunks against the same stream uninterrupted (the router
    resumes it on the survivor from its watermark, so the two must agree:
    generation on the card must not depend on which process runs it); a
    keyed ``Infer`` across a replica kill, answered once; hedging with one
    slow link; the router's host time.  The nine pages also go through a
    router that picks by load (prefix affinity off).  Then the launcher with
    ``--replicas 2`` as subprocesses (``_fleet_launcher``)."""
    import threading

    import numpy as np
    from repro_torch.core import wire
    from repro_torch.core.rpc import Channel, TcpTransport
    from repro_torch.serving import (Engine, InferenceImpl, InProcessReplica,
                                     RouterConfig, ServeConfig,
                                     build_router_server, build_server,
                                     decode_token_page, encode_prompt_page,
                                     service)
    engine = state["engine"]
    cfg = engine.cfg
    ref = Engine(dataclasses.replace(cfg, attention_impl="reference"),
                 ServeConfig(), params=engine.params, device=dev)
    prompts = _prompts(cfg.vocab_size)
    pages = [encode_prompt_page(p[None]) for p in prompts]
    svc = service.InferenceService
    counters = (bd.decode_columns, pa.paged_attention,
                pa.paged_prefill_attention)
    info = {}

    # one replica, called directly: the pages and latencies to compare with
    single = InferenceImpl(engine)
    sserver = build_server(engine, impl=single)
    host, port, _ = sserver.listen_tcp()
    try:
        want, direct_s, direct_wall = _tcp_wave(host, port, pages, FLEET_NEW)
    finally:
        sserver.drain(timeout=30)
        single.close()

    # the same wave through a router with prefix affinity off (the pick by
    # load): the router's cost apart from how this prompt set hashes
    lreps = [InProcessReplica(engine, f"load{i}") for i in range(2)]
    lserver, lrouter = build_router_server(
        lreps, RouterConfig(health_interval_s=0, hedge=False,
                            affinity_prefix=0))
    lhost, lport, _ = lserver.listen_tcp()
    try:
        lgot, load_s, load_wall = _tcp_wave(lhost, lport, pages, FLEET_NEW)
        lserved = [r.impl.batcher.collect_stats()["requests"] for r in lreps]
    finally:
        lserver.drain(timeout=30)
        lrouter.close()
        for r in lreps:
            r.kill()
    info["pages_by_load"] = {
        "requests_per_replica": lserved,
        "vs_one_replica": _match(torch, ref, [p[None] for p in prompts],
                                 lgot, want, "load-picked vs one replica"),
        "router": {**_latency(load_s),
                   "tokens_per_s": len(pages) * FLEET_NEW / load_wall}}

    for fn in counters:
        fn.launches = 0
    reps = [InProcessReplica(engine, f"rep{i}") for i in range(2)]
    rserver, router = build_router_server(
        reps, RouterConfig(health_interval_s=0, hedge=False))
    rhost, rport, _ = rserver.listen_tcp()
    ch = Channel(TcpTransport.connect(rhost, rport))
    try:
        got, routed_s, routed_wall = _tcp_wave(rhost, rport, pages,
                                               FLEET_NEW)
        served = [r.impl.batcher.collect_stats()["requests"] for r in reps]
        info["pages"] = {
            "requests": len(pages), "new_tokens": FLEET_NEW,
            "requests_per_replica": served,
            "vs_one_replica": _match(torch, ref, [p[None] for p in prompts],
                                     got, want, "router vs one replica"),
            "router": {**_latency(routed_s),
                       "tokens_per_s": len(pages) * FLEET_NEW / routed_wall},
            "direct": {**_latency(direct_s),
                       "tokens_per_s": len(pages) * FLEET_NEW / direct_wall}}

        # an InferStream killed after 2 chunks against the same stream
        # uninterrupted, token by token
        sid = svc.method("InferStream").id
        raw = wire.encode(service.InferRequest, {
            "page": pages[8], "max_new_tokens": FLEET_STREAM_NEW})
        whole = _stream_tokens(ch, sid, raw)
        killed = []

        def kill_at_two(n):
            if n == 2 and not killed:
                for rep, robj in zip(reps, router.replicas):
                    if robj.inflight:
                        rep.kill()
                        killed.append(rep.name)
        cut = _stream_tokens(ch, sid, raw, kill_at_two)
        if not killed or router.stats["stream_failovers"] < 1:
            raise AssertionError(f"no stream failover: killed {killed}, "
                                 f"{router.stats}")
        info["stream_kill"] = {
            "killed": killed[0], "tokens": int(whole.size),
            "equal": bool(np.array_equal(cut, whole)),
            "stream_failovers": router.stats["stream_failovers"],
            **_match(torch, ref, [prompts[8][None]], [cut], [whole],
                     "killed stream vs uninterrupted")}
        next(r for r in reps if r.name == killed[0]).restart()
        router.poll()

        # a keyed Infer whose replica dies under it: the router resubmits
        # it to the survivor, and the client gets one answer
        iid = svc.method("Infer").id
        raw = wire.encode(service.InferRequest, {"page": pages[2],
                                             "max_new_tokens": FLEET_NEW})
        victim_r = next(router._ring_order(router._affinity_key(raw)))
        victim = reps[router.replicas.index(victim_r)]
        survivor = next(r for r in reps if r is not victim)
        before = survivor.impl.batcher.collect_stats()["requests"]
        failovers = router.stats["failovers"]
        answers = queue.Queue()
        threading.Thread(target=lambda: answers.put(ch.call(
            iid, raw, timeout=600)), daemon=True).start()
        end = time.monotonic() + 120
        while not victim_r.inflight and time.monotonic() < end:
            time.sleep(0.001)
        if not victim_r.inflight:
            raise AssertionError("the victim never received the Infer")
        victim.kill()
        out = wire.decode(service.InferResponse, bytes(answers.get(timeout=600)))
        tok = decode_token_page(bytes(bytearray(out["page"]))).astype(
            np.int64)
        executed = survivor.impl.batcher.collect_stats()["requests"] - before
        if router.stats["failovers"] <= failovers or executed != 1 \
                or not answers.empty():
            raise AssertionError(f"failover: {router.stats}, survivor ran "
                                 f"it {executed} times")
        info["infer_failover"] = {
            "victim": victim.name, "survivor_executions": executed,
            "failovers": router.stats["failovers"] - failovers,
            **_match(torch, ref, [prompts[2][None]], [tok], [want[2]],
                     "failed-over Infer vs one replica")}
        launches = {f"{fn.__module__.split('.')[-1]}.{fn.__name__}":
                    fn.launches for fn in counters}
    finally:
        ch.close()
        rserver.drain(timeout=30)
        router.close()
        for r in reps:
            r.kill()
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels not launched through the router: "
                             f"{launches}")
    info["launches"] = launches

    # hedging: the first replica's link is slow; its Infers are hedged to
    # the second, which answers first
    slow = InProcessReplica(engine, "slow", latency=HEDGE_LATENCY_S)
    fast = InProcessReplica(engine, "fast")
    hserver, hrouter = build_router_server(
        [slow, fast], RouterConfig(health_interval_s=0, hedge=True,
                                   hedge_delay_ms=HEDGE_DELAY_MS,
                                   affinity_prefix=0))
    hhost, hport, _ = hserver.listen_tcp()
    try:
        hedged = []
        hch = Channel(TcpTransport.connect(hhost, hport))
        for i in (0, 3, 6):
            res = hch.typed(svc).Infer({"page": pages[i],
                                        "max_new_tokens": FLEET_NEW},
                                       timeout=600)
            hedged.append(decode_token_page(bytes(bytearray(
                res["page"]))).astype(np.int64))
        hch.close()
        hs = {k: hrouter.stats[k] for k in ("hedges_fired", "hedges_won",
                                            "hedges_cancelled")}
    finally:
        hserver.drain(timeout=30)
        hrouter.close()
        slow.kill()
        fast.kill()
    if hs["hedges_fired"] < 1 or hs["hedges_won"] < 1:
        raise AssertionError(f"no hedge fired and won: {hs}")
    info["hedging"] = {
        "slow_link_s": HEDGE_LATENCY_S, "hedge_delay_ms": HEDGE_DELAY_MS,
        **hs, "vs_one_replica": _match(
            torch, ref, [prompts[i][None] for i in (0, 3, 6)], hedged,
            [want[i] for i in (0, 3, 6)], "hedged vs one replica")}
    info["router_host"] = _router_host_us(pages[8])
    info["launcher"] = _fleet_launcher(state["src"])
    info["launches_note"] = (
        "launches counted in this process: the in-process router over two "
        "InProcessReplicas; the launcher's replicas are child processes, "
        "whose counters this process cannot read")
    return info


def _children(pid):
    """Process ids whose parent is ``pid`` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(d))
    return sorted(out)


def _nvidia_fds(pid):
    """The NVIDIA device files process ``pid`` holds open: CUDA opens
    them when the process initialises it.  (Mapping ``libcuda.so`` proves
    nothing: importing torch loads it.)"""
    fd_dir = f"/proc/{pid}/fd"
    out = set()
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def _fleet_launcher(src):
    """``python -m repro_torch.launch.serve --arch qwen2-1.5b --full
    --replicas 2``: with ``--once`` it must exit 0 after its probe through
    the router; run long, one replica is SIGKILLed, a request through the
    router is still answered, the supervisor prints its restart line and
    the replica comes back; SIGTERM then drains the router and the
    replicas.  The router process must hold no NVIDIA device file open
    (it never initialises CUDA), and each replica must."""
    import re
    import signal
    import threading

    import numpy as np
    from repro_torch.core.rpc import Channel, TcpTransport
    from repro_torch.serving import encode_prompt_page, service
    env = dict(os.environ, PYTHONPATH=src)
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen2-1.5b", "--full", "--replicas", "2"]
    t0 = time.perf_counter()
    once = subprocess.run(argv + ["--once"], env=env, capture_output=True,
                          text=True, timeout=600)
    probe = [ln for ln in once.stdout.splitlines()
             if ln.startswith("probe generated 4 tokens via router")]
    if once.returncode != 0 or not probe:
        raise AssertionError(f"--replicas 2 --once exited {once.returncode}: "
                             f"{once.stdout[-800:]} {once.stderr[-1500:]}")
    info = {"once": {"exit_code": once.returncode,
                     "seconds": time.perf_counter() - t0,
                     "serving_line": once.stdout.splitlines()[0]}}

    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines = queue.Queue()
    log = []

    def pump():
        for ln in proc.stdout:
            lines.put(ln.rstrip())
    threading.Thread(target=pump, daemon=True).start()

    def wait_line(pattern, timeout):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            try:
                ln = lines.get(timeout=0.5)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            log.append(ln)
            m = re.search(pattern, ln)
            if m:
                return m
        raise AssertionError(f"no line /{pattern}/ from the launcher "
                             f"(exit {proc.poll()}): {log[-20:]}")

    ch = None
    try:
        t0 = time.perf_counter()
        m = wait_line(r"bebop-rpc serving .+ on ([\w.\-]+):(\d+)", 600)
        info["startup_s"] = time.perf_counter() - t0
        kids = _children(proc.pid)
        if len(kids) != 2:
            raise AssertionError(f"router has children {kids}")
        info["nvidia_device_files"] = {
            "router": _nvidia_fds(proc.pid),
            "replicas": [_nvidia_fds(k) for k in kids]}
        if info["nvidia_device_files"]["router"] \
                or not all(info["nvidia_device_files"]["replicas"]):
            raise AssertionError(f"the router initialised CUDA, or a "
                                 f"replica did not: "
                                 f"{info['nvidia_device_files']}")
        ch = Channel(TcpTransport.connect(m.group(1), int(m.group(2))))
        inf = ch.typed(service.InferenceService)
        page = encode_prompt_page(np.arange(1, 41, dtype=np.uint32)[None])

        def answered():
            t1 = time.perf_counter()
            res = inf.Infer({"page": page, "max_new_tokens": 8}, timeout=300)
            if int(res["new_tokens"]) != 8:
                raise AssertionError(f"router answered {res}")
            return (time.perf_counter() - t1) * 1e3
        info["infer_ms_before_kill"] = answered()
        os.kill(kids[0], signal.SIGKILL)
        t1 = time.perf_counter()
        info["infer_ms_after_kill"] = answered()
        info["restart_line"] = wait_line(
            r"\[supervisor\] replica \d exited .*restart", 60).group(0)

        def routable():
            st = inf.Stats({})
            stats = dict(zip(st["names"].split("\n"), st["values"]))
            return sum(stats[f"replica{i}_routable"] for i in range(2))
        # the router's health poll gates the dead replica out, and back in
        # once its successor answers
        seen_down, end = False, time.monotonic() + 300
        while time.monotonic() < end:
            n = routable()
            seen_down |= n < 2
            if seen_down and n == 2:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"replica not back: {log[-20:]}")
        now = _children(proc.pid)
        if len(now) != 2 or kids[0] in now:
            raise AssertionError(f"router children {now}, killed {kids[0]}")
        info["replica_back_s"] = time.perf_counter() - t1
        info["infer_ms_after_restart"] = answered()
        ch.close()
        ch = None
        proc.send_signal(signal.SIGTERM)
        info["exit_code"] = proc.wait(timeout=120)
        if info["exit_code"] != 0:
            raise AssertionError(f"launcher exited {info['exit_code']}: "
                                 f"{log[-20:]}")
    finally:
        if ch is not None:
            ch.close()
        if proc.poll() is None:
            proc.kill()
        try:                     # the replicas share the router's group
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=60)
    return info


# -- the dense paths ------------------------------------------------------------


def _dense_margin(torch, engine, seq) -> float:
    """Top-2 margin of ``engine``'s logits after ``seq``, from a dense
    prefill (the replay engine: the plain versions)."""
    toks = torch.tensor([list(seq)], dtype=torch.int32, device=engine.device)
    logits, _ = engine.model.prefill(engine.params, {"tokens": toks},
                                     len(seq))
    return _margin(logits[0])


def _match(torch, ref, prompts, got, want, what):
    """Greedy tokens of two runs, row by row: equal, or split where the
    plain replay's top-2 margin is within SPLIT_MARGIN, at most MAX_SPLITS
    times.  ``prompts``/``got``/``want`` are lists of [B, T] / [B, n]."""
    import numpy as np
    splits, worst, n = 0, None, 0
    for prompt, a, r in zip(prompts, got, want):
        prompt = np.atleast_2d(prompt)
        if a.shape != r.shape:
            raise AssertionError(f"{what}: shapes {a.shape} vs {r.shape}")
        n += a.size
        for row in range(a.shape[0]):
            diff = np.nonzero(a[row] != r[row])[0]
            if diff.size == 0:
                continue
            j = int(diff[0])
            seq = [int(x) for x in prompt[row]] + [int(x) for x in r[row, :j]]
            margin = _dense_margin(torch, ref, seq)
            if margin > SPLIT_MARGIN:
                raise AssertionError(f"{what}: token split at output {j} "
                                     f"with reference margin {margin}")
            splits += 1
            worst = margin if worst is None else max(worst, margin)
    if splits > MAX_SPLITS:
        raise AssertionError(f"{what}: {splits} splits (limit {MAX_SPLITS})")
    return {"tokens_checked": n, "splits_within_tolerance": splits,
            "largest_split_margin": worst}


def _timed_steps(torch, model, widths):
    """Wrap ``model``'s dense prefill and decode step to record
    (kind, seconds) of each call, synchronized."""
    for name in ("prefill", "decode_step"):
        fn = getattr(model, name)

        def run(*args, _fn=fn, _name=name):
            t0 = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()   # the engine syncs here anyway
            widths.append((_name, time.perf_counter() - t0))
            return out
        setattr(model, name, run)


def _step_summary(widths):
    out = {}
    for kind, sec in widths:
        out.setdefault(kind, []).append(sec * 1e3)
    return {k: {"calls": len(v), "mean_ms": sum(v) / len(v),
                "max_ms": max(v)} for k, v in out.items()}


def _long_prefill(long_widths):
    """The long request's prefill on its own: ms summed over its prefill
    calls (one: the whole prompt at once), where the ``steps`` summary
    mixes it with the wave's."""
    ms = [sec * 1e3 for kind, sec in long_widths if kind == "prefill"]
    return {"long_prefill_ms": sum(ms), "long_prefill_calls": len(ms)}


def _tokens(out):
    from repro_torch.serving import decode_token_page
    return [decode_token_page(r["page"]).astype("int64") for r in out]


def dense_serve(torch, fa, dev, state):
    """qwen2-1.5b through ``ServeConfig(paged=False)``: InferenceImpl ->
    ContinuousBatcher -> Engine.generate (flash attention in the
    prefill); then the paged batcher's dense fallback and score_page."""
    import numpy as np
    from repro_torch.serving import (ContinuousBatcher, Engine,
                                     InferenceImpl, ServeConfig,
                                     encode_prompt_page)
    paged = state["engine"]
    cfg = paged.cfg
    engine = Engine(cfg, ServeConfig(paged=False), params=paged.params,
                    device=dev)
    ref = Engine(dataclasses.replace(cfg, attention_impl="reference"),
                 ServeConfig(paged=False), params=paged.params, device=dev)
    prompts = _prompts(cfg.vocab_size)
    rng = np.random.default_rng(SEED + 5)
    # three one-row pages of one length, sent with the rest: the batcher
    # merges them into one run
    prompts += [rng.integers(0, cfg.vocab_size, 48) for _ in range(3)]
    wave = [(encode_prompt_page(p[None]), NEW_TOKENS) for p in prompts]
    impl = InferenceImpl(engine)
    if not isinstance(impl.batcher, ContinuousBatcher):
        raise AssertionError(f"paged=False gave {type(impl.batcher)}")
    widths = []
    _timed_steps(torch, engine.model, widths)
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = _drive(impl, wave)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    stats = impl.batcher.collect_stats()
    prefills = engine.stats["prefills"]
    if launches < cfg.num_layers * prefills or prefills == 0:
        raise AssertionError(f"flash attention launched {launches} times "
                             f"for {prefills} prefills of {cfg.num_layers} "
                             f"layers")
    if stats["batched_rows"] <= stats["batches"]:
        raise AssertionError(f"no requests merged: {stats}")
    toks = _tokens(out)
    for t, (_, n) in zip(toks, wave):
        if t.shape != (1, n) or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"bad response {t.shape} for {n} tokens")
    ref_impl = InferenceImpl(ref)
    ref_toks = _tokens(_drive(ref_impl, wave))
    vs_plain = _match(torch, ref, [p[None] for p in prompts], toks,
                      ref_toks, "dense vs plain replay")
    n_paged = len(state["serve_tokens"])
    vs_paged = _match(torch, ref, [p[None] for p in prompts[:n_paged]],
                      toks[:n_paged], state["serve_tokens"],
                      "dense vs paged serve")
    # 12 rows exceed the paged batcher's max_batch 8: dense fallback
    big = rng.integers(0, cfg.vocab_size, (12, 24))
    paged_impl = InferenceImpl(paged)
    fa.flash_attention.launches = 0
    res = paged_impl.infer(encode_prompt_page(big), max_new_tokens=8)
    fallback_launches = fa.flash_attention.launches
    paged_stats = paged_impl.batcher.collect_stats()
    paged_impl.close()
    if paged_stats["dense_fallbacks"] != 1 or paged_stats["shed"] != 0:
        raise AssertionError(f"12-row page: {paged_stats}")
    big_toks = _tokens([res])
    fallback = _match(torch, ref, [big], big_toks,
                      [ref.generate(big, max_new_tokens=8)],
                      "dense fallback vs plain replay")
    # score_page on a 2-row page
    page = encode_prompt_page(rng.integers(0, cfg.vocab_size, (2, 64)))
    fa.flash_attention.launches = 0
    scores = impl.score_page(page)["scores"]
    score_launches = fa.flash_attention.launches
    ref_scores = ref_impl.score_page(page)["scores"]
    impl.close()
    ref_impl.close()
    if scores.shape != (2,) or not np.isfinite(scores).all() \
            or float(np.abs(scores - ref_scores).max()) > SCORE_TOL:
        raise AssertionError(f"scores {scores} vs plain {ref_scores}")
    if score_launches < cfg.num_layers:
        raise AssertionError(f"score launched flash {score_launches} times")
    n_tokens = sum(t.size for t in toks)
    state["dense_launches"] = launches
    return {"requests": len(out), "tokens_out": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "stats": stats,
            "engine_stats": dict(engine.stats),
            "steps": _step_summary(widths),
            "launches": {"flash_attention.flash_attention": launches,
                         "dense_fallback": fallback_launches,
                         "score_page": score_launches},
            "tokens_vs_plain": vs_plain, "tokens_vs_paged": vs_paged,
            "dense_fallback": {"stats_dense_fallbacks":
                               paged_stats["dense_fallbacks"], **fallback},
            "scores": scores.tolist(), "plain_scores": ref_scores.tolist(),
            "score_tol": SCORE_TOL}


def hybrid_serve(torch, bd, fa, rg, dev, state):
    """recurrentgemma-9b at full width through InferenceImpl (the default
    ServeConfig gives the dense ContinuousBatcher: the family has no
    paged KV), score_page, and a 2,000-token prompt at cache_len 4096
    whose 100-token decode wraps the 2,048-slot ring cache."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import (ContinuousBatcher, Engine,
                                     InferenceImpl, ServeConfig,
                                     encode_prompt_page)
    cfg = get_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    engine = Engine(cfg, ServeConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref = Engine(plain_cfg, ServeConfig(), params=engine.params, device=dev)
    long_sc = ServeConfig(cache_len=2 * cfg.window)
    long_engine = Engine(cfg, long_sc, params=engine.params, device=dev)
    long_ref = Engine(plain_cfg, long_sc, params=engine.params, device=dev)
    all_prompts = _prompts(cfg.vocab_size)
    prompts = [all_prompts[i] for i in HYBRID_PROMPTS]
    rng = np.random.default_rng(SEED + 8)
    long_prompt = rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT))
    score_page = encode_prompt_page(rng.integers(0, cfg.vocab_size, (2, 64)))
    wave = [(encode_prompt_page(p[None]), NEW_TOKENS) for p in prompts]
    long_page = [(encode_prompt_page(long_prompt), LONG_NEW)]
    impl, long_impl = InferenceImpl(engine), InferenceImpl(long_engine)
    if not isinstance(impl.batcher, ContinuousBatcher):
        raise AssertionError(f"hybrid got {type(impl.batcher)}")
    widths = []
    long_widths = []   # the long request's steps, timed apart
    _timed_steps(torch, engine.model, widths)
    _timed_steps(torch, long_engine.model, long_widths)
    fa.flash_attention.launches = 0
    rg.rglru_scan.launches = 0
    bd.decode_columns.launches = 0
    t0 = time.perf_counter()
    out = _drive(impl, wave)
    wall = time.perf_counter() - t0
    scores = impl.score_page(score_page)["scores"]
    t1 = time.perf_counter()
    long_out = _drive(long_impl, long_page)
    long_wall = time.perf_counter() - t1
    launches = {"flash_attention.flash_attention":
                fa.flash_attention.launches,
                "rglru_scan.rglru_scan": rg.rglru_scan.launches,
                "bebop_decode.decode_columns": bd.decode_columns.launches}
    impl.close()
    long_impl.close()
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the hybrid path: "
                             f"{missing} ({launches})")
    # one page decode for each admitted page: the wave, score, the long one
    pages = len(wave) + 1 + len(long_page)
    if launches["bebop_decode.decode_columns"] != pages:
        raise AssertionError(f"decode_columns launched for {pages} pages: "
                             f"{launches}")
    toks, long_toks = _tokens(out), _tokens(long_out)
    for t, (_, n) in zip(toks + long_toks, wave + long_page):
        if t.shape != (1, n) or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"bad response {t.shape} for {n} tokens")
    ref_impl, long_ref_impl = InferenceImpl(ref), InferenceImpl(long_ref)
    ref_toks = _tokens(_drive(ref_impl, wave))
    ref_scores = ref_impl.score_page(score_page)["scores"]
    ref_long = _tokens(_drive(long_ref_impl, long_page))
    ref_impl.close()
    long_ref_impl.close()
    vs_plain = _match(torch, ref, [p[None] for p in prompts] + [long_prompt],
                      toks + long_toks, ref_toks + ref_long,
                      "hybrid vs plain replay")
    if scores.shape != (2,) or not np.isfinite(scores).all() \
            or float(np.abs(scores - ref_scores).max()) > SCORE_TOL:
        raise AssertionError(f"scores {scores} vs plain {ref_scores}")
    n_tokens = sum(t.size for t in toks)
    state["hybrid_launches"] = launches
    return {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "lru_width": cfg.lru_width, "vocab": cfg.vocab_size,
            "dtype": cfg.dtype, "init_s": init_s,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(engine.params)),
            "requests": len(out), "tokens_out": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "long": {"prompt": LONG_PROMPT, "new_tokens": LONG_NEW,
                     "cache_len": long_sc.cache_len, "window": cfg.window,
                     "wall_s": long_wall,
                     "tokens_per_s": LONG_NEW / long_wall},
            "steps": _step_summary(widths + long_widths),
            **_long_prefill(long_widths), "launches": launches,
            "engine_stats": dict(engine.stats),
            "tokens_vs_plain": vs_plain, "scores": scores.tolist(),
            "plain_scores": ref_scores.tolist(), "score_tol": SCORE_TOL}


def rwkv_serve(torch, bd, rw, dev, state):
    """rwkv6-7b at full width through InferenceImpl (the default
    ServeConfig gives the dense ContinuousBatcher: the family has no paged
    KV): five prompt pages, three 48-token pages that merge, score_page,
    then one 2,000-token page (15 x 128 + 80) for 64 new tokens at a
    cache_len that admits it (RWKV keeps no KV; cache_len only bounds the
    prompt the service takes)."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import (ContinuousBatcher, Engine,
                                     InferenceImpl, ServeConfig,
                                     encode_prompt_page)
    gc.collect()    # the hybrid phase's 18.8 GB of weights
    torch.cuda.empty_cache()
    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    engine = Engine(cfg, ServeConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref = Engine(plain_cfg, ServeConfig(), params=engine.params, device=dev)
    long_sc = ServeConfig(cache_len=2048)
    long_engine = Engine(cfg, long_sc, params=engine.params, device=dev)
    long_ref = Engine(plain_cfg, long_sc, params=engine.params, device=dev)
    all_prompts = _prompts(cfg.vocab_size)
    rng = np.random.default_rng(SEED + 9)
    prompts = [all_prompts[i] for i in HYBRID_PROMPTS] \
        + [rng.integers(0, cfg.vocab_size, 48) for _ in range(3)]
    long_prompt = rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT))
    score_page = encode_prompt_page(rng.integers(0, cfg.vocab_size, (2, 64)))
    wave = [(encode_prompt_page(p[None]), NEW_TOKENS) for p in prompts]
    long_page = [(encode_prompt_page(long_prompt), RWKV_LONG_NEW)]
    impl, long_impl = InferenceImpl(engine), InferenceImpl(long_engine)
    if not isinstance(impl.batcher, ContinuousBatcher):
        raise AssertionError(f"rwkv got {type(impl.batcher)}")
    widths = []
    long_widths = []   # the long request's steps, timed apart
    _timed_steps(torch, engine.model, widths)
    _timed_steps(torch, long_engine.model, long_widths)
    rw.rwkv6_scan.launches = 0
    bd.decode_columns.launches = 0
    t0 = time.perf_counter()
    out = _drive(impl, wave)
    wall = time.perf_counter() - t0
    scores = impl.score_page(score_page)["scores"]
    t1 = time.perf_counter()
    long_out = _drive(long_impl, long_page)
    long_wall = time.perf_counter() - t1
    launches = rw.rwkv6_scan.launches
    page_launches = bd.decode_columns.launches
    stats = impl.batcher.collect_stats()
    impl.close()
    long_impl.close()
    prefills = engine.stats["prefills"] + long_engine.stats["prefills"]
    # one launch per layer per prefill and one per layer for the score
    want = cfg.num_layers * (prefills + 1)
    if launches != want:
        raise AssertionError(f"rwkv6_scan launched {launches} times, not "
                             f"{want} ({prefills} prefills + 1 score x "
                             f"{cfg.num_layers} layers)")
    # the service decodes every admitted page with the page kernel: the
    # wave's, the scored one and the long one
    pages = len(wave) + 1 + len(long_page)
    if page_launches != pages:
        raise AssertionError(f"decode_columns launched {page_launches} "
                             f"times for {pages} pages")
    if stats["batched_rows"] <= stats["batches"]:
        raise AssertionError(f"no requests merged: {stats}")
    toks, long_toks = _tokens(out), _tokens(long_out)
    for t, (_, n) in zip(toks + long_toks, wave + long_page):
        if t.shape != (1, n) or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"bad response {t.shape} for {n} tokens")
    ref_impl, long_ref_impl = InferenceImpl(ref), InferenceImpl(long_ref)
    ref_toks = _tokens(_drive(ref_impl, wave))
    ref_scores = ref_impl.score_page(score_page)["scores"]
    ref_long = _tokens(_drive(long_ref_impl, long_page))
    ref_impl.close()
    long_ref_impl.close()
    vs_plain = _match(torch, ref, [p[None] for p in prompts] + [long_prompt],
                      toks + long_toks, ref_toks + ref_long,
                      "rwkv vs plain replay")
    if scores.shape != (2,) or not np.isfinite(scores).all() \
            or float(np.abs(scores - ref_scores).max()) > SCORE_TOL:
        raise AssertionError(f"scores {scores} vs plain {ref_scores}")
    # first-step logits (after the prompt) of the 400- and 2,000-token
    # prompts, kernel against plain, on fresh models (no step timers)
    kern, plain = get_model(cfg), get_model(plain_cfg)
    logit_diff = {}
    for seq in (prompts[4][None], long_prompt):
        batch = {"tokens": torch.tensor(seq, dtype=torch.int32, device=dev)}
        a, _ = kern.prefill(engine.params, batch, 0)
        r, _ = plain.prefill(engine.params, batch, 0)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite logits at T {seq.shape[1]}")
        logit_diff[str(seq.shape[1])] = float((a.float() - r.float())
                                              .abs().max())
    if max(logit_diff.values()) > RWKV_LOGIT_TOL:
        raise AssertionError(f"first-step logits differ by {logit_diff} "
                             f"(limit {RWKV_LOGIT_TOL})")
    n_tokens = sum(t.size for t in toks)
    state["rwkv_launches"] = launches
    state["rwkv_page_launches"] = page_launches
    return {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.d_model // cfg.rwkv_head_dim,
            "head_dim": cfg.rwkv_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype, "init_s": init_s,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(engine.params)),
            "requests": len(out), "tokens_out": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "stats": stats,
            "long": {"prompt": LONG_PROMPT, "new_tokens": RWKV_LONG_NEW,
                     "cache_len": long_sc.cache_len, "wall_s": long_wall,
                     "tokens_per_s": RWKV_LONG_NEW / long_wall},
            "steps": _step_summary(widths + long_widths),
            **_long_prefill(long_widths),
            "launches": {"rwkv6_scan.rwkv6_scan": launches,
                         "bebop_decode.decode_columns": page_launches},
            "engine_stats": dict(engine.stats),
            "tokens_vs_plain": vs_plain, "scores": scores.tolist(),
            "plain_scores": ref_scores.tolist(), "score_tol": SCORE_TOL,
            "first_step_logits_max_abs_diff": logit_diff,
            "logit_tol": RWKV_LOGIT_TOL}


# -- timing ------------------------------------------------------------------


#: GPU clock cycles of the spin before a ``lead`` call: about 1 ms
LEAD_CYCLES = 2_000_000


def _cold_ms(torch, fn, flush, iters=30, lead=False):
    """Median device time of ``fn`` in ms, CUDA events around each call,
    the 50 MB L2 flushed before each (the serving loop finds a layer's
    pool slice cold: 28 layers of K/V do not fit in L2).  The events
    time the card from when the start event runs, so host work of ``fn``
    that outlasts the flush is counted; with ``lead`` a ~1 ms spin on the
    card after the flush hides it, and what is timed is the launches and
    the kernels alone."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in pairs)
    return ms[len(ms) // 2]


def _host_us(torch, fn, calls=2000):
    """Wall time per call in µs over many calls with one synchronize at
    the end: the wrapper's host time wherever the card keeps up with the
    launches, as it does for kernels of a few µs."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _attn_bound(qpos_rows, t, m, itemsize=2, heads=(HQ, HKV, HD)):
    """Least time for one paged-attention call: bytes (q in, out, each
    row's needed K/V once, tables, positions) over HBM bandwidth vs the
    QK and PV products over bf16 peak; the larger wins."""
    hq, hkv, hd = heads
    b = len(qpos_rows)
    keys = [max(r) + 1 for r in qpos_rows]
    nbytes = (2 * b * hq * t * hd * itemsize
              + sum(keys) * hkv * hd * 2 * itemsize + b * m * 4 + b * t * 4)
    flops = sum(4 * hq * hd * (p + 1) for r in qpos_rows for p in r)
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _flash_flops(b, hq, d, pairs):
    """The QK and PV products of the unmasked (query, key) pairs."""
    return 4 * d * b * hq * pairs


def _flash_bound(b, hq, hkv, tq, s, d, pairs, itemsize=2):
    """Least time for one flash-attention call: bytes (q, k, v in, out)
    over HBM bandwidth vs :func:`_flash_flops` over bf16 peak; the larger
    wins."""
    nbytes = (2 * b * hq * tq * d + 2 * b * hkv * s * d) * itemsize
    flops = _flash_flops(b, hq, d, pairs)
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _causal_pairs(t, window=None):
    """Unmasked (query, key) pairs of causal self-attention over t tokens."""
    w = t if window is None else min(window, t)
    return sum(min(i + 1, w) for i in range(t))


def _wkv_bound(b, h, t, kk, vv, itemsize=2):
    """Least time for one WKV scan: bytes (r, k, v in their dtype, w float32
    read once, u, o written once, the float32 final state) over HBM
    bandwidth vs the 5 float32 operations per state element per step the
    function needs (o_t = S^T r_t + (r_t . (u * k_t)) v_t: a multiply-add,
    the bonus term only O(K + V); S_t = w * S + k v^T: a multiply and a
    multiply-add) over the float32 peak outside the tensor cores; the
    larger wins."""
    nbytes = (b * h * t * (2 * kk + 2 * vv) * itemsize + b * h * t * kk * 4
              + h * kk * 4 + b * h * kk * vv * 4)
    flops = 5 * b * h * t * kk * vv
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def decode_rows(torch, bd, dev, gen, flush):
    """The page decode wrapper at the serve pages' shape and at a bulk
    page: ``ms`` and ``library_ms`` as every kernel row, ``device_ms`` with
    the host's work hidden behind a spin, ``host_us`` the wrapper's host
    time.  Returns {row: entry}; works with any checkout's ``bd``."""
    def row(fn, plain, nbytes, library=None):
        entry = {"ms": _cold_ms(torch, fn, flush),
                 "device_ms": _cold_ms(torch, fn, flush, lead=True),
                 "plain_ms": _cold_ms(torch, plain, flush),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "host_us": _host_us(torch, fn)}
        if library is not None:
            entry["library_ms"] = _cold_ms(torch, library, flush)
            entry["library_host_us"] = _host_us(torch, library)
        return entry

    rows = {}
    # decode_columns at the serve pages' shape: one PromptRecord400 row
    n_tok = max(PROMPT_LENS)
    page = torch.randint(0, 256, (1, 4 * n_tok), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    plan = ((0, n_tok, "uint32", "int32"),)   # a tuple, as ingest passes

    def library():
        # one u32 -> i32 column spanning the whole row is a bitcast: one
        # PyTorch call (a view and its copy) computes the same function
        return page.view(torch.int32).clone()

    if not torch.equal(library(), bd.decode_columns(page, plan)[0]):
        raise AssertionError("decode_columns differs from page.view(int32)")
    rows["decode_columns"] = dict(
        row(lambda: bd.decode_columns(page, plan),
            lambda: bd.decode_columns_plain(page, plan), 2 * page.numel(),
            library),
        shape=f"page [1, {4 * n_tok}] u8 -> [1, {n_tok}] int32 (a bitcast "
              f"column: the kernel's copy path)")
    # the same page and column converted to float32: the staged body at
    # the served page's shape
    to_f32 = ((0, n_tok, "uint32", "float32"),)
    rows[f"decode_columns@1x{4 * n_tok}_u32_to_f32"] = row(
        lambda: bd.decode_columns(page, to_f32),
        lambda: bd.decode_columns_plain(page, to_f32), 2 * page.numel())
    # decode_column (not on the main path) at a bulk page: 16 u32 at offset
    # 0 fill the 64-byte row, a bitcast again
    bulk = torch.randint(0, 256, (65536, 64), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    col = dict(offset=0, count=16, wire_dtype="uint32", out_dtype="int32")
    rows["decode_column"] = dict(
        row(lambda: bd.decode_column(bulk, **col),
            lambda: bd.decode_columns_plain(
                bulk, [(0, 16, "uint32", "int32")]),
            bulk.numel() + 65536 * 64,
            lambda: bulk.view(torch.int32).clone()),
        shape="page [65536, 64] u8 -> [65536, 16] int32 (a bitcast "
              "column: the copy path; not on the served path)")
    # the same page and column converted to float32: the staged body
    f32 = dict(col, out_dtype="float32")
    rows["decode_column@65536x64_u32_to_f32"] = row(
        lambda: bd.decode_column(bulk, **f32),
        lambda: bd.decode_columns_plain(bulk, [(0, 16, "uint32", "float32")]),
        bulk.numel() + 65536 * 64)
    # every wire dtype in one pass; ms holds the host's time too where the
    # wrapper's host work (one output tensor per field) outlasts the flush
    out_bytes = sum(c.element_size() * c.shape[1]
                    for c in bd.decode_columns(bulk[:1], DECODE_PLAN))
    rows["decode_columns@65536x64"] = dict(
        row(lambda: bd.decode_columns(bulk, DECODE_PLAN),
            lambda: bd.decode_columns_plain(bulk, DECODE_PLAN),
            65536 * (64 + out_bytes)),
        fields=len(DECODE_PLAN))
    return rows


def scan_rows(torch, rg, rw, dev, gen, flush, plain=True):
    """The RG-LRU scan at recurrentgemma-9b's longest served prompt of the
    wave (T 400) and its 2,000-token prompt, in the float32 the model feeds
    it; the WKV scan at rwkv6-7b's T 400 and T 2000, bf16 r/k/v and
    float32 w/u as ``[B, H, T, K]`` views of ``[B, T, H, K]``, as the model
    passes them.  Returns {row: entry}, the T 400 rows under the kernels'
    names; works with any checkout's ``rg`` and ``rw``.  ``plain=False``
    leaves out the plain loops (seconds each), which an A/B of two
    checkouts' kernels does not need."""
    rows = {}
    for t in (max(PROMPT_LENS), LONG_PROMPT):
        x = torch.randn((1, t, 4096), generator=gen, device=dev)
        a = torch.rand((1, t, 4096), generator=gen, device=dev)
        h = torch.empty_like(x)
        entry = {
            "ms": _cold_ms(torch, lambda: rg.rglru_scan(x, a), flush),
            "bound_ms": (3 * x.numel() * 4 + 4096 * 4) / HBM_BYTES_PER_S
            * 1e3, "bound_by": "bytes",
            # no single PyTorch call computes a linear recurrence
            # (cumsum/cumprod forms need a division by the running product)
            "library_ms": None, "shape": f"x, a [1, {t}, 4096] float32",
            # yardstick only, another function: one elementwise PyTorch
            # call that moves the same bytes (x and a in, h out)
            "add_same_bytes_ms": _cold_ms(
                torch, lambda: torch.add(x, a, out=h), flush)}
        if plain:
            entry["plain_ms"] = _cold_ms(
                torch, lambda: rg.rglru_scan_plain(x, a), flush, iters=5)
        rows["rglru_scan" if t == max(PROMPT_LENS)
             else f"rglru_scan@T{t}"] = entry
    for t in (max(PROMPT_LENS), LONG_PROMPT):
        r, k, v, w, u = _wkv_inputs(torch, gen, dev, 1, 64, t, 64, 64, 1.0,
                                    0.1, "model", "btk", torch.bfloat16)
        bound, by = _wkv_bound(1, 64, t, 64, 64)
        entry = {
            "ms": _cold_ms(torch, lambda: rw.rwkv6_scan(r, k, v, w, u),
                           flush),
            "bound_ms": bound, "bound_by": by,
            # no single PyTorch call computes the WKV recurrence
            "library_ms": None,
            "shape": f"r, k, v [1, 64, {t}, 64] bf16 (views of [B, T, H, K]),"
                     f" w [1, 64, {t}, 64] f32, u [64, 64] f32"}
        if plain:
            entry["plain_ms"] = _cold_ms(torch, lambda: rw.rwkv6_scan_plain(
                r, k, v, w, u), flush, iters=5)
        rows["rwkv6_scan" if t == max(PROMPT_LENS)
             else f"rwkv6_scan@T{t}"] = entry
    return rows


def timing(torch, bd, pa, fa, rg, rw, dev, state):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    launches = state["launches"]
    kernels, extra = [], {}
    decode = decode_rows(torch, bd, dev, gen, flush)
    for name, line in (("decode_columns", 110), ("decode_column", 69)):
        kernels.append({
            "name": f"bebop_decode.{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bebop_decode.cu",
            "replaces": f"src/repro/kernels/bebop_decode.py:{line}",
            "launches": launches[f"bebop_decode.{name}"],
            "max_abs_err": state["decode_kernel"]["max_abs_err"],
            **decode.pop(name)})
    extra.update({f"bebop_decode.{k}": v for k, v in decode.items()})
    # attention at the serve rows' mid-generation contexts
    rows = _paged_rows(torch, pa, dev, gen, flush, (HQ, HKV, HD))
    for name, line, key, row in (
            ("paged_attention", 109, "decode_bf16_keys1024",
             rows.pop("paged_attention")),
            ("paged_prefill_attention", 215, "prefill_t32_bf16_keys1024",
             rows["paged_prefill_attention@T32"])):
        kernels.append({
            "name": f"paged_attention.{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{line}",
            "launches": launches[f"paged_attention.{name}"],
            "max_abs_err": state["attention_kernels"][f"{key}_max_abs_err"],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape")}})
    extra.update(rows)
    # flash attention at qwen2-1.5b's longest served prefill (B 1, T 400)
    # and, as an extra row, recurrentgemma-9b's long prompt (T 2000)
    for name, (hq, hkv, d, t, window) in FLASH_FULL.items():
        q = torch.randn((1, hq, t, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        k = torch.randn((1, hkv, t, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        v = torch.randn((1, hkv, t, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        pairs = _causal_pairs(t, window)
        bound, by = _flash_bound(1, hq, hkv, t, t, d, pairs)
        entry = {
            "ms": _cold_ms(torch, lambda: fa.flash_attention(
                q, k, v, window=window), flush),
            "plain_ms": _cold_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, window=window), flush),
            "bound_ms": bound, "bound_by": by,
            # yardstick only, the port never calls it: the same function
            # here (Tq == S, q_offset 0, the window wider than T)
            "library_ms": _cold_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), flush),
            "shape": f"B 1, Hq {hq}, Hkv {hkv}, D {d}, T {t}, causal, "
                     f"window {window}, bf16"}
        # the function's flops (4 D a pair) over each call's time
        flops = _flash_flops(1, hq, d, pairs)
        entry["tflops"] = flops / entry["ms"] / 1e9
        entry["library_tflops"] = flops / entry["library_ms"] / 1e9
        if name != "qwen2":
            if name == "recurrentgemma":
                entry["launches_on_hybrid_path"] = state["hybrid_launches"][
                    "flash_attention.flash_attention"]
            extra[f"flash_attention@{name}_T{t}"] = entry
            continue
        kernels.append({
            "name": "flash_attention.flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "launches": state["dense_launches"],
            "max_abs_err": state["flash_kernel"]["bf16_max_abs_err"],
            **entry})
    scans = scan_rows(torch, rg, rw, dev, gen, flush)
    kernels.append({
        "name": "rglru_scan.rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:51",
        "launches": state["hybrid_launches"]["rglru_scan.rglru_scan"],
        "max_abs_err": state["rglru_kernel"]["f32_h_max_abs_err"],
        **scans.pop("rglru_scan")})
    kernels.append({
        "name": "rwkv6_scan.rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:60",
        "launches": state["rwkv_launches"],
        "max_abs_err": state["rwkv_kernel"]["bf16_o_max_abs_err"],
        **scans.pop("rwkv6_scan")})
    extra.update(scans)
    # the same rows at gemma-2b's heads, with gemma_serve's launches
    for key, row in _paged_rows(torch, pa, dev, gen, flush,
                                GEMMA_HEADS).items():
        fn, _, t = key.partition("@")
        row["launches_on_gemma_path"] = state["gemma_launches"][
            f"paged_attention.{fn}"]
        extra[f"{fn}@gemma" + (f"_{t}" if t else "")] = row
    state["kernels"] = kernels
    return {"card": state["smi"], "extra": extra}


def _paged_rows(torch, pa, dev, gen, flush, heads):
    """Both paged kernels in bf16 at ``heads`` (Hq, Hkv, D) and the serve
    rows' mid-generation contexts over the default pool: a row each for
    decode (T 1) and for T 32 and T 5, with the plain version's time, the
    bound, and (T > 1) SDPA on K/V gathered beforehand as a yardstick."""
    import torch.nn.functional as F
    hq, hkv, hd = heads
    ctx = list(ATTN_CTX)
    b = len(ctx)
    m = _table_width(ctx)
    n_blocks = 8 * (1024 // BS) + 1            # the default pool
    kp, vp = _pool(torch, gen, dev, n_blocks, torch.bfloat16, heads)
    tables = _tables(torch, gen, dev, b, m, n_blocks)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q1 = torch.randn((b, hq, hd), generator=gen, device=dev).to(torch.bfloat16)
    shape = (f"B {b}, Hq {hq}, Hkv {hkv}, D {hd}, bs {BS}, M {m}, T {{}}, "
             f"ctx {ctx}, bf16")
    bound, by = _attn_bound([[c - 1] for c in ctx], 1, m, heads=heads)
    rows = {"paged_attention": {
        "ms": _cold_ms(torch, lambda: pa.paged_attention(
            q1, kp, vp, tables, ctx_t), flush),
        "plain_ms": _cold_ms(torch, lambda: pa.paged_attention_plain(
            q1, kp, vp, tables, ctx_t), flush),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": shape.format(1)}}
    for t in (32, 5):
        qpos = [[c - t + i for i in range(t)] for c in ctx]
        qpos_t = torch.tensor(qpos, dtype=torch.int32, device=dev)
        q = torch.randn((b, hq, t, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        bound, by = _attn_bound(qpos, t, m, heads=heads)
        entry = {
            "ms": _cold_ms(torch, lambda: pa.paged_prefill_attention(
                q, kp, vp, tables, qpos_t), flush),
            "plain_ms": _cold_ms(torch, lambda: pa.paged_prefill_attention_plain(
                q, kp, vp, tables, qpos_t), flush),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": shape.format(t)}
        # yardstick only (not the same inputs: K/V pre-gathered, the gather
        # untimed); the port never calls it
        tbl = tables.long()
        kg = kp[tbl].permute(0, 2, 1, 3, 4).reshape(b, hkv, m * BS, hd)
        vg = vp[tbl].permute(0, 2, 1, 3, 4).reshape(b, hkv, m * BS, hd)
        kg = kg.repeat_interleave(hq // hkv, 1)
        vg = vg.repeat_interleave(hq // hkv, 1)
        mask = (torch.arange(m * BS, device=dev)[None, None]
                <= qpos_t.long()[:, :, None])[:, None]
        entry["sdpa_on_gathered_kv_ms"] = _cold_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask), flush)
        rows[f"paged_prefill_attention@T{t}"] = entry
    return rows


if __name__ == "__main__":
    sys.exit(main())
