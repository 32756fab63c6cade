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
  including a 2,000-token prompt;
* the training path (``train``): qwen2-1.5b at full width trained for 10
  AdamW steps on Bebop pages decoded on the card by the page decode
  kernel, checkpointed, restarted, held to the CPU at float32, and its
  trained checkpoint served on the paged kernels; then
  ``launch/train.py`` as a child process;
* the multi-device tooling (``mesh``): the model on DTensors over a (1, 1)
  card mesh, a ``Trainer(mesh=)`` checkpoint restored onto the mesh and
  served on the paged kernels, and two cells of ``launch/dryrun.py`` (256
  and 512 fake ranks, no card) as subprocesses beside it.

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
import contextlib
import dataclasses
import json
import os
import queue
import statistics
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
# qwen2-moe-a2.7b's (MHA, g = 1), granite-moe-1b-a400m's (g = 2, head_dim
# 64) and seamless-m4t-medium's (MHA, head_dim 64)
QMOE_HEADS = (16, 16, 128)
GRANITE_HEADS = (16, 8, 64)
SEAMLESS_HEADS = (16, 16, 64)
SEAMLESS_FRAMES = 50                # the encoder's frames in encdec_serve
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
    # cuBLAS takes its workspace setting when it starts; the train phase's
    # restart check runs under torch.use_deterministic_algorithms(True),
    # which needs this one
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    Phase("moe_serve")(lambda: moe_serve(torch, bd, pa, dev, state))
    Phase("vlm_prefill")(lambda: vlm_prefill(torch, fa, dev, state))
    Phase("encdec_serve")(lambda: encdec_serve(torch, bd, fa, dev, state))
    Phase("train")(lambda: train(torch, bd, fa, pa, rg, rw, dev, state))
    Phase("mesh")(lambda: mesh(torch, bd, pa, dev, state))
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
    heads (bf16 and f32), at gemma-2b's (Hq 8, Hkv 1, D 256), at
    qwen2-moe-a2.7b's (16, 16, 128) and at granite-moe-1b-a400m's (16, 8,
    64: the bf16 body's D 64 build), bf16."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = (torch.bfloat16, ATTN_ATOL, ATTN_RTOL)
    out = {}
    for heads, name, dtypes in (
            ((HQ, HKV, HD), "", (bf16, (torch.float32, F32_ATOL, F32_RTOL))),
            (GEMMA_HEADS, "gemma_", (bf16,)),
            (QMOE_HEADS, "qmoe_", (bf16,)),
            (GRANITE_HEADS, "granite_", (bf16,))):
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
#: queries at an offset, non-causal (and seamless's cross-attention over
#: 50 frames at Tq 400 and at a decode step's Tq 1), both windows at S
#: 2100, and rows whose window holds no key (qpos 14..17 over keys 0..9,
#: window 8)
FLASH_CASES = ((1, 1, True, None, 0), (7, 7, True, None, 0),
               (128, 128, True, None, 0), (400, 400, True, None, 0),
               (64, 300, True, None, 236), (7, 100, True, None, 50),
               (100, 333, False, None, 0),
               (400, SEAMLESS_FRAMES, False, None, 0),
               (1, SEAMLESS_FRAMES, False, None, 0),
               (2100, 2100, True, 8, 0),
               (2100, 2100, True, 2048, 0), (4, 10, True, 8, 14))
#: (Hq, Hkv, D): qwen2-1.5b (and qwen2-vl-2b), recurrentgemma-9b and
#: seamless-m4t-medium (the D 64 build)
FLASH_HEADS = ((12, 2, 128), (16, 1, 256), SEAMLESS_HEADS)
#: the full-width calls the main paths give the flash kernel, B 1:
#: qwen2-1.5b's longest served prompt, recurrentgemma-9b's long one,
#: gemma-2b's heads at T 400 (its dense fallback's shape), and
#: seamless-m4t-medium's causal decoder prefill at T 400 and its
#: cross-attention over 50 frames (name: Hq, Hkv, D, Tq, S, causal, window)
FLASH_FULL = {"qwen2": (HQ, HKV, HD, max(PROMPT_LENS), max(PROMPT_LENS),
                        True, None),
              "recurrentgemma": (16, 1, 256, LONG_PROMPT, LONG_PROMPT, True,
                                 2048),
              "gemma": (*GEMMA_HEADS, max(PROMPT_LENS), max(PROMPT_LENS),
                        True, None),
              "seamless": (*SEAMLESS_HEADS, max(PROMPT_LENS),
                           max(PROMPT_LENS), True, None),
              "seamless_cross": (*SEAMLESS_HEADS, max(PROMPT_LENS),
                                 SEAMLESS_FRAMES, False, None)}
#: the share of bf16 outputs at FLASH_FULL that may differ from the plain
#: version's.  Both sum in f32 and round once to bf16, so they differ only
#: where the two f32 sums straddle a rounding boundary: with the kernel's
#: f32 error (~1e-6 relative, P split into bf16 hi + lo) against a bf16
#: ulp of 2^-8, a few in a thousand.  A P rounded to one bf16 errs by up
#: to 2^-9 relative, half a bf16 ulp, and would move far more.
MAX_BF16_MISMATCH = 0.01


def _flash_tag(name, tq, s):
    return f"{name}_T{tq}" if tq == s else f"{name}_Tq{tq}_S{s}"


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
    for name, (hq, hkv, d, tq, s, causal, window) in FLASH_FULL.items():
        q, k, v = (torch.randn((1, h, t, d), generator=gen, device=dev).to(
            torch.bfloat16) for h, t in ((hq, tq), (hkv, s), (hkv, s)))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        ok, err = _close(torch, got, want, ATTN_ATOL, ATTN_RTOL)
        share = float((got != want).float().mean())
        out[f"bf16_mismatch_share@{_flash_tag(name, tq, s)}"] = share
        if not ok or share > MAX_BF16_MISMATCH:
            raise AssertionError(
                f"flash bf16 {name} Tq {tq} S {s}: max err {err}, "
                f"{share:.4%} of outputs differ from the plain version's "
                f"(limit {MAX_BF16_MISMATCH:.0%})")
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


#: tokens each row of ``_step_logits``' mixed step advances: rows 0-3 a
#: full 32-token chunk, rows 4-5 a 20-token chunk (padding routed to the
#: null block), rows 6-7 one decode token
STEP_ADVANCE = (32, 32, 32, 32, 20, 20, 1, 1)


def _step_logits(torch, cfg, params, models, dev, seed, step=None):
    """Logits of a mixed step and of the decode step after it, for each of
    ``models`` (name: model) on ``params``, from one seeded draw of
    tokens.  ``step(name, model, params, tokens, pool, tables, positions,
    last_idx)`` runs a step (default: ``model.paged_step``)."""
    if step is None:
        def step(name, model, *args):
            return model.paged_step(*args)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, c, m = 8, 32, 4
    tables = (torch.arange(b * m, device=dev, dtype=torch.int32)
              .reshape(b, m) + 1)
    # mixed step: rows 0-3 prefill a full chunk, rows 4-5 a 20-token
    # chunk (padding routed to the null block), rows 6-7 decode one token
    toks = torch.randint(0, cfg.vocab_size, (b, c), generator=gen,
                         device=dev, dtype=torch.int32)
    adv = torch.tensor(STEP_ADVANCE, device=dev)
    pos = torch.minimum(torch.arange(c, device=dev)[None], adv[:, None] - 1)
    pos = pos.to(torch.int32)
    last = (adv - 1).to(torch.int32)
    dec_toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                             device=dev, dtype=torch.int32)
    dec_pos = adv[:, None].to(torch.int32)
    out = {}
    for name, model in models.items():
        pool = model.init_paged_pool(b * m + 1, BS, dev)
        mixed, pool = step(name, model, params, toks, pool, tables, pos,
                           last)
        dec, pool = step(name, model, params, dec_toks, pool, tables,
                         dec_pos, torch.zeros(b, dtype=torch.int32,
                                              device=dev))
        out[name] = (mixed.float(), dec.float())
    return out


def _hold_step_logits(torch, logits, tol, split_margin=SPLIT_MARGIN):
    """The kernel path's step logits against the plain path's: finite,
    within ``tol``, and an argmax split only where the plain top-2 margin
    is within ``split_margin``, at most MAX_SPLITS times."""
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
                if margin > split_margin:
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


def _forced_log():
    return {"positions": 0, "max_abs_logit_diff": 0.0, "split_margins": []}


def _force_step(torch, got, want, valid, log):
    """One step's logits, kernel path ``got`` against the plain model's
    ``want`` on the same inputs ([B, V], or [B, C, V] with ``valid``
    [B, C]): at each valid position the largest difference and the
    argmax.  A split (the kernel path's token is not among the plain
    logits' maxima: where those tie, argmax's first index is one choice of
    several) is logged with its margin, how far the plain token leads the
    kernel's in the plain logits."""
    if got.dim() == 2:
        got, want, valid = got[:, None], want[:, None], valid[:, :1]
    g, w = got.float(), want.float()
    log["positions"] += int(valid.sum())
    log["max_abs_logit_diff"] = max(log["max_abs_logit_diff"], float(
        ((g - w).abs().amax(-1) * valid).max()))
    picked = torch.gather(w, -1, g.argmax(-1, keepdim=True))[..., 0]
    for b, c in ((picked < w.amax(-1)) & valid).nonzero().tolist():
        k, p = int(g[b, c].argmax()), int(w[b, c].argmax())
        log["split_margins"].append(float(w[b, c, p] - w[b, c, k]))


def _serve_wave(torch, bd, pa, dev, engine, forced=None, limits=None):
    """The serve traffic through ``engine``'s paged path: the nine prompt
    pages x NEW_TOKENS at once, then a one-token follow-up of the first,
    through ``InferenceImpl.infer`` under the default ServeConfig.  Fails
    unless the three kernels of the path launched, the scheduler took its
    mixed, spec-verify, prefix-hit and copy-on-write paths, and the greedy
    tokens equal a replay through the plain versions under the split rule.

    With ``forced`` (the plain model of an MoE engine; ``limits``: its
    logit limit and split margin) there is no replay.  An MoE step's
    capacity, and so which tokens drop, depends on how the scheduler
    composed the step (which prompts' prefixes were cached first, where
    the chunks start), which a second run need not repeat; and where
    rounding moves a router input across a top-k boundary, a token takes
    another expert (a route flip) and its logits move far more than the
    rounding.  So each step is held to the plain model on the same step
    inputs, on a copy of the kernel path's own pool (teacher forcing),
    with the experts the kernel path chose (``_Routes``): the logits at
    every position the step computes within the limit, a split only at a
    plain margin within the split margin (``_hold_forced``), and the
    route flips counted.  Returns (info, token arrays)."""
    from repro_torch.serving import (InferenceImpl, decode_token_page,
                                     encode_prompt_page)

    cfg = engine.cfg
    widths = []   # (step width, seconds) of every model step in the run
    log = {**_forced_log(), "route_flips": 0, "token_layers": 0}
    counters = (bd.decode_columns, bd.decode_column, pa.paged_attention,
                pa.paged_prefill_attention)
    routes = _Routes() if forced is not None else None
    for name in ("paged_step", "paged_step_verify"):
        fn = getattr(engine.model, name)

        def run(params, tokens, pool, *args, _fn=fn, _name=name):
            if routes is not None:
                before = {k: v.clone() for k, v in pool.items()}
                torch.cuda.synchronize()   # the copy is not the step's
                routes.start("kernel")
            t0 = time.perf_counter()
            out = _fn(params, tokens, pool, *args)
            torch.cuda.synchronize()   # the batcher syncs here anyway
            widths.append((int(tokens.shape[1]), time.perf_counter() - t0))
            if routes is not None:
                routes.mode = "forced"
                want, _ = getattr(forced, _name)(params, tokens, before,
                                                 *args)
                routes.mode = None
                del before
                # every position up to last_idx; empty batch slots (an
                # all-null block table) attend the null block, which the
                # step's padding writes in no fixed order, and nothing
                # reads their logits
                tables, last = args[0], args[-1]
                valid = (tables[:, :1] != 0) & (torch.arange(
                    tokens.shape[1], device=dev)[None] <= last.long()[:, None])
                _force_step(torch, out[0], want, valid, log)
                log["route_flips"] += routes.flips("forced", valid)
                log["token_layers"] += int(valid.sum()) * cfg.num_layers
            return out
        setattr(engine.model, name, run)
    prompts = _prompts(cfg.vocab_size)
    # the wave, then a one-token follow-up of the first prompt: its only
    # generation step has no draft budget, so it is a plain decode step
    # (T == 1), and it re-reads a cached prefix block it must copy on write
    wave = [(encode_prompt_page(p[None]), NEW_TOKENS) for p in prompts]
    follow = [(encode_prompt_page(prompts[0][None]), 1)]
    impl = InferenceImpl(engine)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = _drive(impl, wave) + _drive(impl, follow)
    wall = time.perf_counter() - t0
    launches = {f"{fn.__module__.split('.')[-1]}.{fn.__name__}": fn.launches
                for fn in counters}
    stats = impl.batcher.collect_stats()
    impl.close()
    if routes is not None:
        routes.close()
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
    n_tokens = sum(r["new_tokens"] for r in out)
    if forced is not None:
        checked = {**_hold_forced(log, *limits),
                   "route_flips": log["route_flips"],
                   "token_layers": log["token_layers"]}
    else:
        splits, worst = _replay_splits(torch, engine, dev, prompts, toks,
                                       wave + follow)
        checked = {"tokens_checked": n_tokens,
                   "splits_within_tolerance": splits,
                   "largest_split_margin": worst,
                   "split_margin": SPLIT_MARGIN, "max_splits": MAX_SPLITS}
    by_width = {}
    for w, s in widths:
        by_width.setdefault(w, []).append(s * 1e3)
    return {"requests": len(out), "tokens_out": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "launches": launches,
            # the teacher-forced plain steps run inside the wave, outside
            # the steps' timers
            "wall_includes_forced_steps": forced is not None,
            "steps": len(widths),
            "step_ms_by_width": {
                str(w): {"steps": len(v), "mean_ms": sum(v) / len(v),
                         "max_ms": max(v)} for w, v in sorted(by_width.items())},
            "stats": stats, "tokens_vs_plain": checked}, toks


def _hold_forced(log, logit_tol, split_margin=SPLIT_MARGIN):
    """The teacher-forced comparison ``log`` (``_force_step``): the
    logits within ``logit_tol`` at every checked position, and an argmax
    split only where the plain logits' own top-2 margin is within
    ``split_margin``.  The splits are counted, not limited: every
    position is compared on the kernel path's own prefix, so a split ends
    no comparison, and the logit limit holds every position."""
    margins = log["split_margins"]
    if log["max_abs_logit_diff"] > logit_tol:
        raise AssertionError(f"forced steps: logits differ by "
                             f"{log['max_abs_logit_diff']} (limit "
                             f"{logit_tol})")
    if any(m > split_margin for m in margins):
        raise AssertionError(f"forced steps split from the plain model at "
                             f"plain margins {margins} (limit "
                             f"{split_margin})")
    return {"positions_checked": log["positions"],
            "max_abs_logit_diff": log["max_abs_logit_diff"],
            "logit_tol": logit_tol, "splits_within_tolerance": len(margins),
            "split_margins": margins, "split_margin": split_margin}


def _replay_splits(torch, engine, dev, prompts, toks, requests):
    """The wave's greedy tokens against a replay of ``requests`` through
    the plain attention, called by name via the config: equal, or split
    where the replay's top-2 margin is within SPLIT_MARGIN, at most
    MAX_SPLITS requests.  Returns (splits, largest split margin)."""
    import numpy as np
    from repro_torch.serving import (Engine, InferenceImpl, ServeConfig,
                                     decode_token_page)
    ref = Engine(dataclasses.replace(engine.cfg, attention_impl="reference"),
                 ServeConfig(), params=engine.params, device=dev)
    ref_impl = InferenceImpl(ref)
    n = len(PROMPT_LENS)
    ref_out = _drive(ref_impl, requests[:n]) + _drive(ref_impl, requests[n:])
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
    return splits, worst


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
    prefill of the engine's own batch for it (the replay engine: the plain
    versions; the encoder-decoder's zero frames)."""
    import numpy as np
    batch = engine._prefill_batch(np.asarray([list(seq)], dtype=np.int32))
    logits, _ = engine.model.prefill(engine.params, batch, len(seq))
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


def _timed_steps(torch, model, widths, forced=None, log=None):
    """Wrap ``model``'s dense prefill and decode step to record
    (kind, seconds) of each call, synchronized.  With ``forced`` (the
    plain model) each call's logits are first computed by it on the same
    inputs and a copy of the cache, and held to the kernel path's in
    ``log`` (``_force_step``)."""
    for name in ("prefill", "decode_step"):
        fn = getattr(model, name)
        ref = None if forced is None else getattr(forced, name)

        def run(*args, _fn=fn, _name=name, _ref=ref):
            if _ref is not None:
                ref_args = list(args)
                if _name == "decode_step":    # params, tokens, cache, pos
                    ref_args[2] = {k: v.clone() for k, v in args[2].items()}
                want, _ = _ref(*ref_args)
                del ref_args
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()   # the engine syncs here anyway
            widths.append((_name, time.perf_counter() - t0))
            if _ref is not None:
                _force_step(torch, out[0], want, torch.ones_like(
                    out[0][:, :1], dtype=torch.bool), log)
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


# -- the other model families ---------------------------------------------------

# The MoE models' checks.  Where the kernel and plain paths' router inputs
# straddle a top-k boundary, a token takes another expert at that layer (a
# route flip), and its logits then move far more than the attention's
# rounding alone moves them: qwen2-moe-a2.7b's mixed step differed by 0.734
# with 706 of 4,080 (layer, token) routes flipped, granite-moe-1b-a400m's by
# 0.089 with 399 (PERF.md, section 2).  Those differences and flips are
# reported; what is held is the plain model on the kernel path's own routes
# (``_Routes``), where the difference is rounding only.  (arch: logit limit,
# split margin) on those routes, each about twice the largest reading of
# chip_smoke.py's serve wave on an H100: qwen2-moe's untied unembed gives
# logits of about twice qwen2's scale (top logits near 4, where one bf16
# step is 0.03125); its difference reached 0.121 and its splits' plain
# margins 0.0625, two bf16 steps.  granite's difference (0.035) and splits
# (none) fit LOGIT_TOL and SPLIT_MARGIN.
MOE_LIMITS = {"qwen2-moe-a2.7b": (0.25, 0.125),
              "granite-moe-1b-a400m": (LOGIT_TOL, SPLIT_MARGIN)}
# seamless-m4t-medium's encoder memory from random frames, kernel path
# against plain (bf16, unit RMS after the encoder's final norm): 0.082
# measured on an H100, the limit about twice that
MEMORY_TOL = 0.16
VLM_TEXT, VLM_GRID = 16, (16, 24)   # qwen2-vl-2b's prompt: text, patches
ENCDEC_NEW = 16                     # new tokens of each seamless page


class _Routes:
    """Records and forces MoE routes by standing in for
    ``repro_torch.models.moe.route``, which ``moe_ffn_grouped`` and
    ``moe_ffn_global`` look up as a module global: the package needs no
    hook.  While ``mode`` names a run, each router call's expert ids are
    appended to that run's list; in the run "forced" each call then takes
    the ids of the same call of the run "kernel" instead, weighted by its
    own router's renormalised probabilities of them."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        self.mode, self.ids = None, {}
        moe.route = self

    def start(self, mode):
        self.mode, self.ids = mode, {}

    def __call__(self, p, x, cfg):
        probs, weights, idx = self.route(p, x, cfg)
        if self.mode is not None:
            seen = self.ids.setdefault(self.mode, [])
            seen.append(idx)
            if self.mode == "forced":
                idx = self.ids["kernel"][len(seen) - 1]
                weights = probs.gather(-1, idx)
                weights = weights / weights.sum(-1, keepdim=True).clamp_min(
                    1e-9)
        return probs, weights, idx

    def flips(self, run, valid, first=0, layers=None) -> int:
        """(layer, valid token) pairs whose own expert sets differ between
        the run ``run`` and the run "kernel", over the router calls
        ``first`` to ``first + layers``; ``valid`` [B, C]."""
        stop = None if layers is None else first + layers
        return sum(int(((a.sort(-1).values != r.sort(-1).values).any(-1)
                        & valid).sum()) for a, r in zip(
            self.ids["kernel"][first:stop], self.ids[run][first:stop]))

    def close(self):
        self.moe.route = self.route


def _moe_step_logits(torch, cfg, params, models, dev, seed):
    """``_step_logits`` of an MoE decoder for the models "kernel" and
    "plain", and for "plain" again with the kernel path's routes forced
    ("forced"): their logits, and the route flips between kernel and
    plain per step, (layer, valid token) pairs whose chosen expert set
    differs."""
    routes = _Routes()

    def step(name, model, *args):
        routes.mode = name
        try:
            return model.paged_step(*args)
        finally:
            routes.mode = None
    routes.start(None)
    try:
        logits = _step_logits(torch, cfg, params,
                              {**models, "forced": models["plain"]}, dev,
                              seed, step)
    finally:
        routes.close()
    n = cfg.num_layers
    adv = torch.tensor(STEP_ADVANCE, device=dev)
    valid = (torch.arange(32, device=dev)[None] < adv[:, None],
             torch.ones((len(STEP_ADVANCE), 1), dtype=torch.bool,
                        device=dev))
    flips = {step: {"flips": routes.flips("plain", valid[j], j * n, n),
                    "token_layers": int(valid[j].sum()) * n}
             for j, step in enumerate(("mixed", "decode"))}
    return logits, flips


def _weight_bound_ms(params, cfg) -> float:
    """Least time a step could take to read the weights once: every
    parameter but the embedding table's unread rows (an untied table is
    only gathered) over the card's memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if not cfg.tie_embeddings:
        nbytes -= params["embed"].numel() * params["embed"].element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def _moe_serve_one(torch, bd, pa, dev, arch, seed):
    """One MoE model at full width on the paged path: its step logits
    against the plain attention's with the route flips, then the serve
    phase's traffic and checks (``_serve_wave``), its step time by width
    beside the per-step weight-read bound."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serving import Engine, ServeConfig
    cfg = get_config(arch)
    limits = MOE_LIMITS[arch]
    t0 = time.perf_counter()
    engine = Engine(cfg, ServeConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not engine.supports_paged:
        raise AssertionError(f"{arch} is not on the paged path")
    m = cfg.moe
    info = {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "experts": m.num_experts,
            "shared_experts": m.num_shared, "top_k": m.top_k,
            "d_expert": m.d_expert, "capacity_factor": m.capacity_factor,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype, "init_s": init_s,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(engine.params)),
            "router_dtype": str(engine.params["layers"]["moe"]["router"]
                                .dtype)}
    if engine.params["layers"]["moe"]["router"].dtype != torch.float32:
        raise AssertionError("the router is not float32")
    plain = DecoderLM(dataclasses.replace(cfg, attention_impl="reference"))
    logits, flips = _moe_step_logits(
        torch, cfg, engine.params, {"kernel": engine.model, "plain": plain},
        dev, seed)
    # on its own routes the plain model differs by flips as well, which
    # are reported; on the kernel path's it differs by rounding only
    info["routes_own"] = {"route_flips": flips, **{
        f"{step}_max_abs_logit_diff": float((a - r).abs().max())
        for step, a, r in zip(("mixed", "decode"), logits["kernel"],
                              logits["plain"])}}
    info["routes_forced"] = _hold_step_logits(
        torch, {"kernel": logits["kernel"], "plain": logits["forced"]},
        *limits)
    wave, _ = _serve_wave(torch, bd, pa, dev, engine, forced=plain,
                          limits=limits)
    bound = _weight_bound_ms(engine.params, cfg)
    wave["weight_bound_ms"] = bound
    wave["step_ms_over_weight_bound"] = {
        w: v["mean_ms"] / bound for w, v in wave["step_ms_by_width"].items()}
    del engine, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {**info, **wave}


def moe_serve(torch, bd, pa, dev, state):
    """qwen2-moe-a2.7b at full width (24 layers, d_model 2048, 16 heads of
    128 over 16 KV heads, 60 routed experts of 1,408 top-4 and 4 shared,
    vocab 151,936, bf16) on the paged path, then granite-moe-1b-a400m at
    full width (24 layers, d_model 1024, 16 heads of 64 over 8, 32 experts
    of 512 top-8, tied embedding, vocab 49,155): the paged D 64 body's
    first path.  Each: step logits against the plain attention's with the
    route flips, and the serve phase's traffic (``_moe_serve_one``)."""
    import gc
    gc.collect()     # the earlier phases' weights
    torch.cuda.empty_cache()
    out = {}
    for arch, seed, key in (("qwen2-moe-a2.7b", SEED + 13, "moe"),
                            ("granite-moe-1b-a400m", SEED + 14, "granite")):
        out[arch] = _moe_serve_one(torch, bd, pa, dev, arch, seed)
        state[f"{key}_launches"] = out[arch]["launches"]
    return out


def _greedy_vs_plain(torch, kern, plain, params, batch, cache_len, n_new,
                     tol, what):
    """``prefill`` and ``n_new`` greedy ``decode_step``s through the kernel
    path ``kern`` and the plain replay ``plain``, each free running: the
    logits finite and within ``tol`` while the tokens agree, and the
    tokens equal or split where the replay's top-2 margin at that step is
    within SPLIT_MARGIN (a row is compared up to its split).  B 1."""
    la, ca = kern.prefill(params, batch, cache_len)
    lr, cr = plain.prefill(params, batch, cache_len)
    t = batch["positions"].shape[-1] if "positions" in batch \
        else batch["tokens"].shape[1]
    worst, split, toks = 0.0, None, []
    for i in range(n_new + 1):
        if not bool(torch.isfinite(la).all()):
            raise AssertionError(f"{what}: non-finite logits at step {i}")
        if split is None:
            worst = max(worst, float((la.float() - lr.float()).abs().max()))
            if int(la[0].argmax()) != int(lr[0].argmax()):
                margin = _margin(lr[0])
                if margin > SPLIT_MARGIN:
                    raise AssertionError(f"{what}: token split at output "
                                         f"{i} with reference margin "
                                         f"{margin}")
                split = {"output": i, "margin": margin}
        if i == n_new:
            break
        ta = la.argmax(-1, keepdim=True).to(torch.int32)
        tr = lr.argmax(-1, keepdim=True).to(torch.int32)
        toks.append(int(ta[0, 0]))
        la, ca = kern.decode_step(params, ta, ca, t + i)
        lr, cr = plain.decode_step(params, tr, cr, t + i)
    if worst > tol:
        raise AssertionError(f"{what}: logits differ by {worst} (limit "
                             f"{tol})")
    return {"new_tokens": n_new, "max_abs_logit_diff": worst,
            "logit_tol": tol, "split": split, "tokens": toks}


def vlm_prefill(torch, fa, dev, state):
    """qwen2-vl-2b at full width (28 layers, d_model 1536, 12 heads of 128
    over 2, M-RoPE sections (16, 24, 24), tied embedding, bf16) from 400
    seeded random embeddings: 16 text positions at t = h = w = 0..15, then
    a 16 x 24 patch grid at t 16, h 16 + row, w 16 + col.  ``prefill``
    (the flash kernel in every layer), then 32 greedy ``decode_step``s
    against the plain replay.  There is no ``Engine`` path, as in JAX."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config("qwen2-vl-2b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plain = get_model(dataclasses.replace(cfg, attention_impl="reference"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    rows, cols = VLM_GRID
    n = VLM_TEXT + rows * cols
    pos = torch.empty((3, 1, n), dtype=torch.int32, device=dev)
    pos[:, 0, :VLM_TEXT] = torch.arange(VLM_TEXT, device=dev)
    grid = torch.arange(rows * cols, device=dev)
    pos[0, 0, VLM_TEXT:] = VLM_TEXT
    pos[1, 0, VLM_TEXT:] = VLM_TEXT + grid // cols
    pos[2, 0, VLM_TEXT:] = VLM_TEXT + grid % cols
    batch = {"embeds": torch.randn((1, n, cfg.d_model), generator=gen,
                                   device=dev), "positions": pos}
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    model.prefill(params, batch, n + NEW_TOKENS)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = fa.flash_attention.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"flash attention launched {launches} times in "
                             f"a prefill of {cfg.num_layers} layers")
    res = _greedy_vs_plain(torch, model, plain, params, batch,
                           n + NEW_TOKENS, NEW_TOKENS, LOGIT_TOL,
                           "vlm vs plain replay")
    state["vlm_launches"] = launches
    info = {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "mrope_sections": list(cfg.mrope_sections), "dtype": cfg.dtype,
            "init_s": init_s, "param_bytes": sum(
                t.numel() * t.element_size() for t in _leaves(params)),
            "prompt": {"text": VLM_TEXT, "grid": list(VLM_GRID)},
            "prefill_ms": prefill_ms,
            "launches": {"flash_attention.flash_attention": launches},
            **res}
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return info


def encdec_serve(torch, bd, fa, dev, state):
    """seamless-m4t-medium at full width (12 + 12 layers, d_model 1024, 16
    heads of 64, vocab 256,206, bf16): ``prefill`` and 32 greedy
    ``decode_step``s from seeded random frames [1, 50, 1024] and the
    400-token prompt against the plain replay (memory, logits, tokens);
    then the nine prompt pages x 16 tokens through ``InferenceImpl`` (the
    ``ContinuousBatcher``: the stub frontend's zero frames), each prefill
    and decode step held to the plain model on the same inputs and a copy
    of the cache (``_timed_steps(forced=...)``), and ``score_page``.  The flash kernel runs the encoder, the decoder's
    prefill and every cross-attention (12 launches a decode step)."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import (ContinuousBatcher, Engine,
                                     InferenceImpl, ServeConfig,
                                     encode_prompt_page)
    cfg = get_config("seamless-m4t-medium")
    t0 = time.perf_counter()
    engine = Engine(cfg, ServeConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if engine.supports_paged:
        raise AssertionError("the encoder-decoder has no paged path")
    params = engine.params
    ref = Engine(dataclasses.replace(cfg, attention_impl="reference"),
                 ServeConfig(), params=params, device=dev)
    prompts = _prompts(cfg.vocab_size)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    frames = torch.randn((1, SEAMLESS_FRAMES, cfg.d_model), generator=gen,
                         device=dev)
    batch = {"frames": frames, "tokens": torch.tensor(
        prompts[-1][None], dtype=torch.int32, device=dev)}
    fa.flash_attention.launches = 0
    mem = engine.model.encode(params, frames)
    mem_err = float((mem.float() - ref.model.encode(params, frames).float())
                    .abs().max())
    if mem_err > MEMORY_TOL or not bool(torch.isfinite(mem).all()):
        raise AssertionError(f"encoder memory differs by {mem_err} (limit "
                             f"{MEMORY_TOL})")
    frames_run = _greedy_vs_plain(
        torch, engine.model, ref.model, params, batch, ServeConfig().cache_len,
        NEW_TOKENS, LOGIT_TOL, "encdec (random frames) vs plain replay")
    frames_launches = fa.flash_attention.launches
    # encode: 12; prefill: 12 encoder + 12 self + 12 cross; 12 a step
    n = cfg.num_layers
    want = cfg.encoder_layers * 2 + 2 * n + NEW_TOKENS * n
    if frames_launches != want:
        raise AssertionError(f"flash attention launched {frames_launches} "
                             f"times, not {want}")
    # the served path: zero frames, the dense batcher
    wave = [(encode_prompt_page(p[None]), ENCDEC_NEW) for p in prompts]
    rng = np.random.default_rng(SEED + 17)
    score_page = encode_prompt_page(rng.integers(0, cfg.vocab_size, (2, 64)))
    impl = InferenceImpl(engine)
    if not isinstance(impl.batcher, ContinuousBatcher):
        raise AssertionError(f"seamless got {type(impl.batcher)}")
    widths = []
    log = _forced_log()
    _timed_steps(torch, engine.model, widths, forced=ref.model, log=log)
    fa.flash_attention.launches = 0
    bd.decode_columns.launches = 0
    t0 = time.perf_counter()
    out = _drive(impl, wave)
    wall = time.perf_counter() - t0
    scores = impl.score_page(score_page)["scores"]
    launches = {"flash_attention.flash_attention":
                fa.flash_attention.launches,
                "bebop_decode.decode_columns": bd.decode_columns.launches}
    impl.close()
    stats = dict(engine.stats)
    # each prefill and the score's logits: the encoder, the decoder's self-
    # and cross-attention (36); each decode step its cross-attention (12)
    want = (cfg.encoder_layers + 2 * n) * (stats["prefills"] + 1) \
        + n * stats["decode_steps"]
    if launches["flash_attention.flash_attention"] != want:
        raise AssertionError(f"flash attention launched {launches} times, "
                             f"not {want} ({stats})")
    if launches["bebop_decode.decode_columns"] != len(wave) + 1:
        raise AssertionError(f"decode_columns launched for "
                             f"{len(wave) + 1} pages: {launches}")
    toks = _tokens(out)
    for t, (_, k) in zip(toks, wave):
        if t.shape != (1, k) or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"bad response {t.shape} for {k} tokens")
    ref_impl = InferenceImpl(ref)
    ref_scores = ref_impl.score_page(score_page)["scores"]
    ref_impl.close()
    vs_plain = _hold_forced(log, LOGIT_TOL)
    if scores.shape != (2,) or not np.isfinite(scores).all() \
            or float(np.abs(scores - ref_scores).max()) > SCORE_TOL:
        raise AssertionError(f"scores {scores} vs plain {ref_scores}")
    n_tokens = sum(t.size for t in toks)
    state["encdec_launches"] = launches["flash_attention.flash_attention"]
    info = {"encoder_layers": cfg.encoder_layers, "decoder_layers": n,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
            "dtype": cfg.dtype, "init_s": init_s,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
            "random_frames": {"frames": SEAMLESS_FRAMES,
                              "prompt": len(prompts[-1]),
                              "memory_max_abs_diff": mem_err,
                              "memory_tol": MEMORY_TOL,
                              "flash_launches": frames_launches,
                              **frames_run},
            "requests": len(out), "tokens_out": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "launches": launches,
            "steps": _step_summary(widths), "engine_stats": stats,
            "tokens_vs_plain": vs_plain, "scores": scores.tolist(),
            "plain_scores": ref_scores.tolist(), "score_tol": SCORE_TOL}
    del engine, ref, params
    gc.collect()
    torch.cuda.empty_cache()
    return info


# -- training ------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH = 512, 8     # 4,096 tokens a step; page stride 2,068
TRAIN_STEPS = 10
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
TRAIN_EXAMPLES = 96                 # 12 batches: the 10 steps' and a spare
TRAIN_PAGE = 32                     # records per page
PROFILE_STEP = 6                    # the step profiled inside the run
#: make_train_step's profiler ranges: the forward, and compression + AdamW
STEP_RANGES = ("train_step/forward", "train_step/optimizer")
# The restart check (5 steps, save, resume for 5) runs at 4 layers of full
# width: at 28 layers each save and restore moves the whole 15.4 GB
# checkpoint (params, f32 moments; 40 s to save and 23 s to restore on an
# H100 host), three of them for the restart alone.
# The 28-layer checkpoint is saved once and restored once (the trained
# weights that serve).
RESTART_LAYERS = 4
# The CPU-against-card step: 2 layers at full width and full vocabulary,
# float32, TF32 off, one [1, 128] batch.  The loss within 1e-5 relative,
# each gradient leaf within atol 3e-5 * max|g| and rtol 1e-4 (the f32
# tolerances of the JAX kernel tests), the params AdamW updates from the
# same grads within 1e-6.
CPU_LAYERS, CPU_SEQ = 2, 128
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-5, 1e-4
PARAM_ATOL = 1e-6


def _card_batches(torch, buf, dc, layout, dev, held, cursor=0):
    """``device_batches``' raw pages, copied to the card and decoded there
    by ``decode_page_device`` (the page decode kernel); each batch is held
    bit-equal to the host ``Pipeline``'s batch at the same cursor, and its
    cursor appended to ``held``."""
    import numpy as np
    from repro_torch.core.device import decode_page_device
    from repro_torch.data import BufferSource, Pipeline, device_batches
    src = BufferSource(buf)
    host = Pipeline(dc, [src], len(src), cursor=cursor)
    host_it = iter(host)
    try:
        for payload, cur in device_batches(buf, dc, cursor=cursor):
            page = torch.from_numpy(payload.copy()).to(dev)
            tokens = decode_page_device(page, layout)["tokens"]
            batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
            want, want_cur = next(host_it)
            got = tokens.cpu().numpy()
            if cur != want_cur or not np.array_equal(
                    got[:, :-1], want["tokens"]) or not np.array_equal(
                    got[:, 1:], want["labels"]):
                raise AssertionError(f"card-decoded batch at cursor {cur} "
                                     f"differs from the host pipeline's "
                                     f"(cursor {want_cur})")
            held.append(cur)
            yield batch, cur
    finally:
        host.stop()


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _profiled(torch, fn, ranges=()):
    """``fn()`` under ``torch.profiler`` as ``profile`` runs it: wall ms,
    device busy ms (the sum of the card's kernels and copies), the idle
    share, and each ``record_function`` range in ``ranges`` with the device
    ms of the kernels launched inside it (``device_time_total`` of its host
    event; kernels launched from another thread, as autograd's backward
    on the card is, fall outside every range).  The card-side copy of a
    range the profiler records (its span, not work) is left out of the
    busy sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    ev = [e for e in events if e.device_type == DeviceType.CUDA
          and e.name not in ranges]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    top = {}
    for e in ev:
        top[e.name[:60]] = top.get(e.name[:60], 0.0) \
            + e.time_range.elapsed_us() / 1e3
    in_range = {r: sum(e.device_time_total for e in events
                       if e.name == r and e.device_type == DeviceType.CPU)
                / 1e3 for r in ranges}
    return out, {"wall_ms": wall, "device_busy_ms": busy if ev else None,
                 "device_idle_share": 1 - busy / wall if ev else None,
                 "device_ops": len(ev), "range_device_ms": in_range,
                 "top_device_ms": dict(sorted(top.items(),
                                              key=lambda kv: -kv[1])[:12])}


def _timed_trainer(torch, trainer, times, profile_at, prof):
    """Time each train step between two synchronizes (``times``: step
    number -> s), except step ``profile_at``, which runs under the
    profiler into ``prof``."""
    step_fn = trainer._train_step

    def step(*args):
        n = trainer.step + 1
        if n == profile_at:
            out, info = _profiled(torch, lambda: step_fn(*args),
                                  STEP_RANGES)
            fwd, opt = (info["range_device_ms"][r] for r in STEP_RANGES)
            prof.update(info, step=n, forward_device_ms=fwd,
                        optimizer_device_ms=opt,
                        backward_and_rest_device_ms=info["device_busy_ms"]
                        - fwd - opt)
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times[n] = time.perf_counter() - t0
        return out

    trainer._train_step = step


def _train_flops(params, cfg, b, t):
    """6 N per token for the matrices, plus causal attention's QK and PV
    products forward and backward (3 x 4 D a (query, key) pair)."""
    n = sum(p.numel() for p in _leaves(params))
    attn = 12 * cfg.head_dim * cfg.num_heads * b * _causal_pairs(t) \
        * cfg.num_layers
    return 6 * n * b * t + attn, n


def train(torch, bd, fa, pa, rg, rw, dev, state):
    """The port's training path at the full width of qwen2-1.5b (28 layers,
    d_model 1536, 12/2 heads of 128, vocab 151,936, bf16, 1.54 B
    parameters, random weights from a seeded ``torch.Generator``):
    Zipf pages written by ``write_example_pages`` at seq_len 512, batches of
    8 from ``device_batches`` decoded on the card (the page decode kernel),
    10 AdamW steps through ``Trainer.run`` into a checkpoint; a restart
    that must resume the uninterrupted run's losses bit for bit; one f32
    step on the card against the CPU; the trained checkpoint restored and
    served on the paged kernels; every wrapper's grad guard; and the
    launcher as a child process."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager, flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.data import (DataConfig, example_layout,
                                  synthetic_corpus, write_example_pages)
    from repro_torch.models import DecoderLM
    from repro_torch.train import OptimizerConfig, TrainConfig, Trainer
    from repro_torch.train import optimizer as O
    # the earlier phases' weights: the serve phases' engine (its params and
    # KV pool) lives on in ``state`` until here
    state.pop("engine", None)
    state.pop("plain_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-1.5b")
    toks = synthetic_corpus(TRAIN_SEQ, TRAIN_EXAMPLES, cfg.vocab_size,
                            seed=SEED + 20)
    buf = write_example_pages(TRAIN_SEQ, toks, records_per_page=TRAIN_PAGE)
    dc = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    records_per_page=TRAIN_PAGE)
    layout = example_layout(TRAIN_SEQ)
    opt = OptimizerConfig(**TRAIN_OPT)
    info = {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype, "seq": TRAIN_SEQ,
            "batch": TRAIN_BATCH, "page_stride": layout.stride,
            "optimizer": TRAIN_OPT,
            "memory_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    tmp = tempfile.mkdtemp(prefix="train_phase_")
    try:
        # 1. ten steps at full width, batches decoded on the card
        held, times, prof, save_s = [], {}, {}, []
        torch.cuda.reset_peak_memory_stats()
        bd.decode_columns.launches = 0
        data = _card_batches(torch, buf, dc, layout, dev, held)
        t0 = time.perf_counter()
        tr = Trainer(cfg, opt, TrainConfig(
            steps=TRAIN_STEPS, ckpt_every=10 * TRAIN_STEPS,
            ckpt_dir=os.path.join(tmp, "a"), log_every=1, seed=SEED),
            data=data, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _timed_trainer(torch, tr, times, PROFILE_STEP, prof)
        save = tr._save

        def timed_save(blocking=False):
            t = time.perf_counter()
            save(blocking)
            save_s.append(time.perf_counter() - t)
        tr._save = timed_save
        res = tr.run()
        data.close()
        launches = bd.decode_columns.launches
        peak = torch.cuda.max_memory_allocated()
        losses = [lv for _, lv in res["losses"]]
        if res["status"] != "done" or res["step"] != TRAIN_STEPS \
                or len(losses) != TRAIN_STEPS \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"training ended {res}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        if launches != TRAIN_STEPS or held != [
                TRAIN_BATCH * (i + 1) for i in range(TRAIN_STEPS)]:
            raise AssertionError(f"{launches} decode launches for batches "
                                 f"at cursors {held}")
        # steps 2-10 but the profiled one (step 1 warms the allocator and
        # cuBLAS up)
        med = statistics.median(t * 1e3 for n, t in times.items() if n > 1)
        flops, n_params = _train_flops(tr.params, cfg, TRAIN_BATCH,
                                       TRAIN_SEQ)
        bound_ms = flops / BF16_FLOPS_PER_S * 1e3
        ckpt_dir = os.path.join(tmp, "a", f"step_{TRAIN_STEPS}")
        info.update({
            "params": n_params, "init_s": init_s, "losses": losses,
            "decode_launches": launches, "batches_held_to_host": len(held),
            "step_ms": {n: t * 1e3 for n, t in times.items()},
            "step_ms_median": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
            "peak_memory_gb": peak / 1e9,
            "step_flops": flops, "flop_bound_ms": bound_ms,
            "share_of_flop_bound": bound_ms / med,
            "profiled_step": prof,
            "checkpoint_save_s": save_s[-1],
            "checkpoint_gb": _dir_bytes(ckpt_dir) / 1e9})
        # 4. the trained checkpoint restores bit for bit and serves on the
        # paged kernels
        template = O.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            {"params": tr.params, "opt": tr.opt_state})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, man = CheckpointManager(os.path.join(tmp, "a")).restore(
            TRAIN_STEPS, template, device=dev)
        torch.cuda.synchronize()
        info["checkpoint_restore_s"] = time.perf_counter() - t0
        if int(man["step"]) != TRAIN_STEPS \
                or int(man["data_cursor"]) != tr.data_cursor:
            raise AssertionError(f"manifest {man['step']} / "
                                 f"{man['data_cursor']}")
        for (name, got), (_, want) in zip(
                flatten_tree(restored), flatten_tree({"params": tr.params,
                                                      "opt": tr.opt_state})):
            if got.dtype != want.dtype or got.shape != want.shape \
                    or not torch.equal(got, want):
                raise AssertionError(f"restored {name} differs")
        del tr, res, template
        gc.collect()
        torch.cuda.empty_cache()
        params = restored["params"]
        del restored
        kern = DecoderLM(cfg)
        plain = DecoderLM(dataclasses.replace(cfg,
                                              attention_impl="reference"))
        pa.paged_attention.launches = pa.paged_prefill_attention.launches = 0
        with torch.inference_mode():
            served = _hold_step_logits(torch, _step_logits(
                torch, cfg, params, {"kernel": kern, "plain": plain}, dev,
                SEED + 21), LOGIT_TOL)
        served["launches"] = {
            "paged_attention": pa.paged_attention.launches,
            "paged_prefill_attention": pa.paged_prefill_attention.launches}
        if min(served["launches"].values()) < cfg.num_layers:
            raise AssertionError(f"paged kernels launched "
                                 f"{served['launches']}")
        info["trained_weights_serve"] = dict(served, logit_tol=LOGIT_TOL)
        del params, kern, plain
        gc.collect()
        torch.cuda.empty_cache()
        # 2. restart: 5 steps and a save, then a new Trainer resumes
        info["restart"] = _restart(torch, cfg, opt, buf, dc, layout, dev,
                                   os.path.join(tmp, "b"))
        # 3. one float32 step on the card against the CPU
        info["cpu_vs_card"] = _cpu_vs_card(torch, cfg, toks, dev)
        # 5. the guard: no wrapper launches under grad on an input that
        # requires grad
        info["grad_guard"] = _grad_guard(torch, bd, fa, pa, rg, rw, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # 6. the launcher, with the card to itself
    info["launcher"] = _launcher_train(state["src"])
    state["train_launches"] = launches
    info["card"] = state["smi"]
    return info


@contextlib.contextmanager
def _deterministic(torch):
    """``torch.use_deterministic_algorithms(True)``: every op on the
    training path takes its deterministic form (the embedding's and the
    CE gather's backward accumulate by a sort, not by atomics), so a run
    repeats bit for bit.  The NaN fill of new tensors that the mode also
    turns on (a check for reads of uninitialized memory) stays off: it
    costs a pass over every allocation of the step."""
    import torch.utils.deterministic as det
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def _restart(torch, cfg, opt, buf, dc, layout, dev, ckpt):
    """At RESTART_LAYERS layers of full width, under
    ``torch.use_deterministic_algorithms(True)``: 10 uninterrupted steps;
    then 5 steps and a save, and a new Trainer on the same directory that
    resumes at step 5 and the saved cursor.  Steps 6-10 must give the
    uninterrupted run's losses bit for bit."""
    from repro_torch.train import TrainConfig, Trainer
    rcfg = dataclasses.replace(cfg, num_layers=RESTART_LAYERS)

    def trainer(steps, ckpt_dir):
        return Trainer(rcfg, opt, TrainConfig(
            steps=steps, ckpt_every=10 * TRAIN_STEPS, ckpt_dir=ckpt_dir,
            log_every=1, seed=SEED), data=iter(()), device=dev)

    def run(tr):
        held = []
        tr.data = _card_batches(torch, buf, dc, layout, dev, held,
                                cursor=tr.data_cursor)
        res = tr.run()
        tr.data.close()
        return res

    with _deterministic(torch):
        full = run(trainer(TRAIN_STEPS, None))
        first = run(trainer(TRAIN_STEPS // 2, ckpt))
        t0 = time.perf_counter()
        resumed = trainer(TRAIN_STEPS, ckpt)
        restore_s = time.perf_counter() - t0
        at = (resumed.step, resumed.data_cursor)
        second = run(resumed)
    half = TRAIN_STEPS // 2
    if at != (half, half * TRAIN_BATCH):
        raise AssertionError(f"resumed at step/cursor {at}")
    want = full["losses"][half:]
    if second["losses"] != want or first["losses"] != full["losses"][:half]:
        raise AssertionError(f"restart losses {second['losses']} != "
                             f"uninterrupted {want}")
    return {"layers": RESTART_LAYERS, "deterministic_algorithms": True,
            "resumed_at": {"step": at[0], "cursor": at[1]},
            "losses_6_10": [lv for _, lv in second["losses"]],
            "bit_equal_to_uninterrupted": True,
            "trainer_init_with_restore_s": restore_s,
            "checkpoint_gb": _dir_bytes(ckpt) / 1e9}


def _cpu_vs_card(torch, cfg, toks, dev):
    """One float32 step of a CPU_LAYERS-layer qwen2-1.5b at full width and
    vocabulary on the card and on the CPU, same params and batch."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models import get_model
    from repro_torch.train import OptimizerConfig
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import loss_and_grads
    ccfg = dataclasses.replace(cfg, num_layers=CPU_LAYERS, dtype="float32",
                               attention_impl="reference")
    model = get_model(ccfg)
    cpu = torch.device("cpu")
    p_cpu = model.init(SEED + 22, cpu)
    p_dev = O.tree_map(lambda t: t.to(dev), p_cpu)
    seq = torch.from_numpy(toks[:1, :CPU_SEQ + 1].astype("int32"))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    t0 = time.perf_counter()
    l_cpu, g_cpu = loss_and_grads(model, p_cpu, batch)
    cpu_s = time.perf_counter() - t0
    l_dev, g_dev = loss_and_grads(model, p_dev, O.tree_map(
        lambda t: t.to(dev), batch))
    rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    if rel > LOSS_RTOL:
        raise AssertionError(f"loss {float(l_dev)} on the card, "
                             f"{float(l_cpu)} on the CPU")
    worst = {}
    for (name, gd), (_, gc_) in zip(flatten_tree(g_dev),
                                    flatten_tree(g_cpu)):
        gd = gd.cpu()
        scale = float(gc_.abs().max())
        excess = float(((gd - gc_).abs() - GRAD_RTOL * gc_.abs()).max())
        worst[name] = excess / scale if scale else excess
        if excess > GRAD_ATOL * scale:
            raise AssertionError(f"grad {name}: |card - cpu| - "
                                 f"{GRAD_RTOL}|cpu| = {excess}, limit "
                                 f"{GRAD_ATOL} * {scale}")
    # AdamW from the same (CPU) grads on both devices
    opt = OptimizerConfig(**TRAIN_OPT)
    new_cpu, _ = O.adamw_update(g_cpu, O.init_opt_state(p_cpu, opt),
                                p_cpu, opt)
    new_dev, _ = O.adamw_update(O.tree_map(lambda t: t.to(dev), g_cpu),
                                O.init_opt_state(p_dev, opt), p_dev, opt)
    param_err = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b)
                    in zip(flatten_tree(new_dev), flatten_tree(new_cpu)))
    if param_err > PARAM_ATOL:
        raise AssertionError(f"updated params differ by {param_err}")
    return {"layers": CPU_LAYERS, "seq": CPU_SEQ, "dtype": "float32",
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "loss_card": float(l_dev), "loss_cpu": float(l_cpu),
            "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
            "grad_worst_excess_over_max": max(worst.values()),
            "grad_atol_times_max": GRAD_ATOL, "grad_rtol": GRAD_RTOL,
            "updated_param_max_abs_diff": param_err,
            "param_atol": PARAM_ATOL, "cpu_step_s": cpu_s}


def _grad_guard(torch, bd, fa, pa, rg, rw, dev):
    """Each CUDA wrapper, under grad mode with an input that requires grad,
    raises ``ValueError`` before launching; under ``torch.no_grad()`` the
    same call launches.  (A page that requires grad can only be a float
    tensor: the guard refuses it before the wrapper's dtype check.)"""
    def f(*shape):
        return torch.randn(shape, device=dev, requires_grad=True)
    q, kv = f(1, 2, 4, 64), f(1, 1, 4, 64)
    pool = torch.zeros((3, 1, 16, 64), device=dev)
    tables = torch.ones((1, 2), dtype=torch.int32, device=dev)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    x = f(1, 4, 16)
    r, u = f(1, 2, 4, 16), torch.zeros((2, 16), device=dev)
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, kv, kv),
        "paged_attention": lambda: pa.paged_attention(
            q[:, :, 0].contiguous(), pool, pool, tables, pos[:, 0] + 1),
        "paged_prefill_attention": lambda: pa.paged_prefill_attention(
            q, pool, pool, tables, pos),
        "rglru_scan": lambda: rg.rglru_scan(x, x.detach()),
        "rwkv6_scan": lambda: rw.rwkv6_scan(r, r, r, r, u),
        "decode_columns": lambda: bd.decode_columns(
            f(2, 8), [(0, 2, "uint32", "int32")]),
        "decode_column": lambda: bd.decode_column(
            f(2, 8), offset=0, count=2, wire_dtype="uint32"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if f"{name}: the CUDA kernel has no backward" not in str(e):
                raise
            out[name] = "refused"
        else:
            raise AssertionError(f"{name} launched under grad")
    with torch.no_grad():
        before = fa.flash_attention.launches
        fa.flash_attention(q, kv, kv)
        if fa.flash_attention.launches != before + 1:
            raise AssertionError("flash attention did not launch under "
                                 "no_grad")
    return out


def _launcher_train(src):
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --full
    --steps 4 --seq-len 512 --global-batch 8`` as a subprocess: it must
    exit 0 and print ``finished: done at step 4``."""
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "qwen2-1.5b", "--full", "--steps", "4",
                          "--seq-len", str(TRAIN_SEQ), "--global-batch",
                          str(TRAIN_BATCH)], env=env, capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or "finished: done at step 4" not in lines:
        raise AssertionError(f"launcher exited {out.returncode}: "
                             f"{out.stdout[-500:]} {out.stderr[-1500:]}")
    return {"exit_code": out.returncode,
            "seconds": time.perf_counter() - t0, "lines": lines}


# -- mesh ----------------------------------------------------------------------

MESH_BATCH, MESH_SEQ = 2, 256       # the DTensor forward's tokens
MESH_STEPS = 2                      # the Trainer(mesh=) run, RESTART_LAYERS deep
MESH_PROMPTS, MESH_NEW = 4, 8       # the restored weights' greedy requests
#: the dry run as a user runs it: one train cell on the 256-rank mesh, one
#: long-context decode cell on the 512-rank mesh
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", "single"),
                ("rwkv6-7b", "long_500k", "multi"))
#: qwen2-1.5b's MODEL_FLOPS (6 N D) over the traced per-device FLOPs x 256:
#: full remat recomputes the forward (8 N D of products) and the attention
#: adds its own, so about 6/8 less the attention's share; a count at the
#: global shapes would read 1/256 of that
USEFUL_RANGE = (0.5, 0.95)


def mesh(torch, bd, pa, dev, state):
    """The multi-device tooling on one card: ``make_host_mesh()`` (a CUDA
    (1, 1) mesh over a one-rank NCCL group); full-width qwen2-1.5b (bf16,
    plain attention) logits with its params placed by ``param_specs`` on
    that mesh, in ``tp`` and in ``fsdp`` with the per-layer gather, held
    bit-equal to the plain forward; a ``Trainer(mesh=)`` at
    RESTART_LAYERS layers of full width whose manifest records the mesh,
    its checkpoint restored onto the mesh by ``shardings=`` (every leaf a
    DTensor with the requested placements, its local tensor the saved
    bits), and the restored weights served on the paged path (page decode,
    paged decode and prefill attention) with the greedy tokens the same
    weights gave before the save; and ``python -m
    repro_torch.launch.dryrun`` for DRYRUN_CELLS as subprocesses, which run
    on the CPU beside the card work."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import CheckpointManager, flatten_tree
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import (DataConfig, example_layout,
                                  synthetic_corpus, write_example_pages)
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch import shardings as S
    from repro_torch.models import DecoderLM
    from repro_torch.train import OptimizerConfig, TrainConfig, Trainer
    from repro_torch.train import optimizer as O
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mesh_phase_")
    procs = [_dryrun_start(state["src"], cell, tmp) for cell in DRYRUN_CELLS]
    info = {"dryrun_cells": [list(c) for c in DRYRUN_CELLS]}
    try:
        t0 = time.perf_counter()
        m = make_host_mesh()
        info["mesh"] = {"shape": list(m.shape),
                        "axes": list(m.mesh_dim_names),
                        "device_type": m.device_type,
                        "backend": dist.get_backend()}
        if tuple(m.shape) != (1, 1) or tuple(m.mesh_dim_names) != (
                "data", "model") or m.device_type != dev.type:
            raise AssertionError(f"host mesh {info['mesh']}")
        # 1. DTensor logits, bit-equal to the plain forward
        cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                                  attention_impl="reference")
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        tokens = torch.randint(0, cfg.vocab_size, (MESH_BATCH, MESH_SEQ),
                               generator=gen, device=dev)
        params = DecoderLM(cfg).init(SEED + 30, dev)
        with torch.no_grad():
            plain = DecoderLM(cfg).logits(params, {"tokens": tokens})
            forward = {}
            for mode in ("tp", "fsdp"):
                mcfg = dataclasses.replace(
                    cfg, fsdp_per_layer_gather=mode == "fsdp")
                specs = S.param_specs(mcfg, params, m, mode=mode)
                dparams = S.distribute(params, m, specs)
                dtokens = S.distribute({"tokens": tokens}, m, S.batch_specs(
                    mcfg, ShapeConfig("mesh", MESH_SEQ, MESH_BATCH,
                                      "prefill"), m, mode=mode))
                with implicit_replication():
                    out = DecoderLM(mcfg).logits(dparams, dtokens)
                if not isinstance(out, DTensor):
                    raise AssertionError(f"{mode}: logits not a DTensor")
                got = out.to_local()
                sharded = sum(1 for _, s in _spec_leaves(specs)
                              if any(e is not None for e in s))
                forward[mode] = {
                    "bit_equal": bool(torch.equal(got, plain)),
                    "max_abs_diff": float((got.float()
                                           - plain.float()).abs().max()),
                    "sharded_leaves": sharded}
                if not forward[mode]["bit_equal"]:
                    raise AssertionError(f"{mode} DTensor logits differ: "
                                         f"{forward[mode]}")
                del dparams, out, got
        info["dtensor_forward"] = dict(forward, batch=MESH_BATCH,
                                       seq=MESH_SEQ, layers=cfg.num_layers,
                                       dtype=cfg.dtype)
        del params, plain
        gc.collect()
        torch.cuda.empty_cache()
        info["forward_s"] = time.perf_counter() - t0
        # 2. Trainer(mesh=), the checkpoint restored onto the mesh, served
        t0 = time.perf_counter()
        rcfg = dataclasses.replace(get_config("qwen2-1.5b"),
                                   num_layers=RESTART_LAYERS)
        toks = synthetic_corpus(TRAIN_SEQ, TRAIN_EXAMPLES, rcfg.vocab_size,
                                seed=SEED + 31)
        buf = write_example_pages(TRAIN_SEQ, toks,
                                  records_per_page=TRAIN_PAGE)
        dc = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        records_per_page=TRAIN_PAGE)
        held = []
        data = _card_batches(torch, buf, dc, example_layout(TRAIN_SEQ), dev,
                             held)
        ckpt = os.path.join(tmp, "ckpt")
        tr = Trainer(rcfg, OptimizerConfig(**TRAIN_OPT), TrainConfig(
            steps=MESH_STEPS, ckpt_every=10 * MESH_STEPS, ckpt_dir=ckpt,
            log_every=1, seed=SEED), data=data, device=dev, mesh=m)
        res = tr.run()
        data.close()
        man = CheckpointManager(ckpt).manifest(MESH_STEPS)
        if res["status"] != "done" or [int(x) for x in man["mesh_shape"]] \
                != [1, 1] or list(man["mesh_axes"]) != ["data", "model"]:
            raise AssertionError(f"trainer {res['status']}, manifest mesh "
                                 f"{man['mesh_shape']} {man['mesh_axes']}")
        saved = {"params": tr.params, "opt": tr.opt_state}
        before, launches_before = _mesh_serve(torch, bd, pa, dev, rcfg,
                                              tr.params)
        pspecs = S.param_specs(rcfg, tr.params, m)
        specs = {"params": pspecs, "opt": S.opt_state_specs(
            rcfg, pspecs, tr.params, m)}
        template = O.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            saved)
        shardings = S.named(m, specs)
        restored, _ = CheckpointManager(ckpt).restore(
            MESH_STEPS, template, shardings=shardings)
        want_pl = dict(_spec_leaves(S.tree_map_specs(
            lambda n: tuple(n.placements), shardings)))
        for (name, got), (_, want) in zip(flatten_tree(restored),
                                          flatten_tree(saved)):
            local = got.to_local() if isinstance(got, DTensor) else None
            if local is None or local.device.type != dev.type \
                    or tuple(got.placements) != want_pl[name] \
                    or local.dtype != want.dtype \
                    or not torch.equal(local, want):
                raise AssertionError(
                    f"restored {name} is not the saved leaf placed "
                    f"{want_pl[name]}: {getattr(got, 'placements', None)}, "
                    f"{None if local is None else local.device}")
        del tr, saved
        after, launches_after = _mesh_serve(
            torch, bd, pa, dev, rcfg,
            O.tree_map(lambda t: t.to_local(), restored["params"]))
        if after != before:
            raise AssertionError("the restored weights' greedy tokens "
                                 "differ from the saved weights'")
        info["checkpoint"] = {
            "layers": RESTART_LAYERS, "steps": MESH_STEPS,
            "manifest_mesh_shape": [int(x) for x in man["mesh_shape"]],
            "manifest_mesh_axes": list(man["mesh_axes"]),
            "leaves_restored_as_dtensors": len(want_pl),
            "leaves_sharded": sum(1 for p in want_pl.values()
                                  if any(not q.is_replicate() for q in p)),
            "served_tokens_equal": True,
            "tokens": sum(len(t) for t in after),
            "launches_before_save": launches_before,
            "launches_after_restore": launches_after}
        del restored
        gc.collect()
        torch.cuda.empty_cache()
        info["checkpoint_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
        # 3. the dry runs
        t0 = time.perf_counter()
        info["dryrun"] = [_dryrun_finish(p, cell, tmp)
                          for p, cell in zip(procs, DRYRUN_CELLS)]
        info["dryrun_wait_s"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    info["card"] = state["smi"]
    return info


def _spec_leaves(tree, path=""):
    """(slash path, leaf) of a nested dict, specs and tuples as leaves."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _spec_leaves(v, f"{path}/{k}" if path else k)]
    return [(path, tree)]


def _mesh_serve(torch, bd, pa, dev, cfg, params):
    """MESH_PROMPTS greedy requests of MESH_NEW tokens, one after another,
    through an Engine on ``params`` (plain CUDA tensors): page decode,
    paged batcher, paged attention.  Returns (token lists, launches); fails unless the three
    kernels of the path launched."""
    from repro_torch.serving import (Engine, InferenceImpl, ServeConfig,
                                     decode_token_page, encode_prompt_page)
    counters = (bd.decode_columns, pa.paged_attention,
                pa.paged_prefill_attention)
    engine = Engine(cfg, ServeConfig(), params=params, device=dev)
    impl = InferenceImpl(engine)
    for fn in counters:
        fn.launches = 0
    try:
        # one request at a time: the steps' composition, and so every
        # rounding, repeats from one engine to the next
        out = [impl.infer(encode_prompt_page(p[None]),
                          max_new_tokens=MESH_NEW)
               for p in _prompts(cfg.vocab_size)[:MESH_PROMPTS]]
    finally:
        impl.close()
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels not launched: {launches}")
    return [decode_token_page(r["page"])[0].tolist() for r in out], launches


def _dryrun_start(src, cell, tmp):
    arch, shape, mesh_kind = cell
    out = os.path.join(tmp, f"dryrun_{arch}_{shape}_{mesh_kind}")
    env = dict(os.environ, PYTHONPATH=src)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh_kind, "--out", out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _dryrun_finish(proc, cell, tmp):
    """One dry-run record: status ok, the mesh's rank count, and for a
    train cell a useful ratio in USEFUL_RANGE."""
    arch, shape, mesh_kind = cell
    try:
        log, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    path = os.path.join(tmp, f"dryrun_{arch}_{shape}_{mesh_kind}",
                        f"{arch}__{shape}__{mesh_kind}__baseline.json")
    if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"dryrun {cell} exited {proc.returncode}: "
                             f"{log[-1500:]}")
    with open(path) as f:
        rec = json.load(f)
    chips = 512 if mesh_kind == "multi" else 256
    if rec["status"] != "ok" or rec["chips"] != chips:
        raise AssertionError(f"dryrun {cell}: {rec.get('status')} on "
                             f"{rec.get('chips')} ranks")
    if shape == "train_4k" and not (
            USEFUL_RANGE[0] <= rec["useful_ratio"] <= USEFUL_RANGE[1]):
        raise AssertionError(f"dryrun {cell}: useful ratio "
                             f"{rec['useful_ratio']} outside {USEFUL_RANGE}")
    keys = ("chips", "lower_s", "compile_s", "flops_per_device",
            "bytes_per_device", "collective_bytes", "collective_counts",
            "compute_s", "memory_s", "collective_s", "dominant",
            "step_time_lower_bound_s", "useful_ratio", "model_flops",
            "argument_size_in_bytes", "temp_size_in_bytes")
    return {"cell": list(cell), **{k: rec[k] for k in keys}}


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


def _train_decode_row(torch, bd, dev, gen, flush, launches):
    """The page decode kernel at the train path's page: 8 TrainExample512
    records (stride 2,068), doc_id and tokens in one launch.  No single
    PyTorch call computes both columns, so no library time."""
    from repro_torch.core.device import default_out_dtype
    from repro_torch.data import example_layout
    layout = example_layout(TRAIN_SEQ)
    plan = tuple(c.as_field(default_out_dtype(c.wire_dtype))
                 for c in layout.columns)
    page = torch.randint(0, 256, (TRAIN_BATCH, layout.stride),
                         generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    outs = bd.decode_columns(page, plan)
    if not all(torch.equal(a, b) for a, b in
               zip(outs, bd.decode_columns_plain(page, plan))):
        raise AssertionError("train page decode differs from its plain "
                             "version")
    nbytes = page.numel() + sum(o.numel() * o.element_size() for o in outs)
    return {"ms": _cold_ms(torch, lambda: bd.decode_columns(page, plan),
                           flush),
            "plain_ms": _cold_ms(
                torch, lambda: bd.decode_columns_plain(page, plan), flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "launches_on_train_path": launches,
            "shape": f"page [{TRAIN_BATCH}, {layout.stride}] u8 -> doc_id "
                     f"[{TRAIN_BATCH}, 16] uint8, tokens [{TRAIN_BATCH}, "
                     f"{TRAIN_SEQ + 1}] int32"}


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
    kernels[0]["launches_on_train_path"] = state["train_launches"]
    extra["bebop_decode.decode_columns@train"] = _train_decode_row(
        torch, bd, dev, gen, flush, state["train_launches"])
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
    # and, as extra rows, the other FLASH_FULL calls
    on_path = {"recurrentgemma": ("launches_on_hybrid_path",
                                  state["hybrid_launches"][
                                      "flash_attention.flash_attention"]),
               "seamless": ("launches_on_encdec_path",
                            state["encdec_launches"]),
               "seamless_cross": ("launches_on_encdec_path",
                                  state["encdec_launches"])}
    for name, (hq, hkv, d, tq, s, causal, window) in FLASH_FULL.items():
        q = torch.randn((1, hq, tq, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        k = torch.randn((1, hkv, s, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        v = torch.randn((1, hkv, s, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        pairs = _causal_pairs(tq, window) if causal else tq * s
        bound, by = _flash_bound(1, hq, hkv, tq, s, d, pairs)
        entry = {
            "ms": _cold_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window), flush),
            "plain_ms": _cold_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), flush),
            "bound_ms": bound, "bound_by": by,
            # yardstick only, the port never calls it: the same function
            # here (Tq == S where causal, q_offset 0, the window wider
            # than T)
            "library_ms": _cold_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), flush),
            "shape": f"B 1, Hq {hq}, Hkv {hkv}, D {d}, Tq {tq}, S {s}, "
                     f"{'causal' if causal else 'non-causal'}, "
                     f"window {window}, bf16"}
        # the function's flops (4 D a pair) over each call's time
        flops = _flash_flops(1, hq, d, pairs)
        entry["tflops"] = flops / entry["ms"] / 1e9
        entry["library_tflops"] = flops / entry["library_ms"] / 1e9
        if name != "qwen2":
            if name in on_path:
                entry[on_path[name][0]] = on_path[name][1]
            extra[f"flash_attention@{_flash_tag(name, tq, s)}"] = entry
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
    # the same rows at gemma-2b's, qwen2-moe-a2.7b's and
    # granite-moe-1b-a400m's heads, with the launches of their paths
    for tag, heads, path in (("gemma", GEMMA_HEADS, "gemma"),
                             ("qwen2_moe", QMOE_HEADS, "moe"),
                             ("granite_moe", GRANITE_HEADS, "granite")):
        for key, row in _paged_rows(torch, pa, dev, gen, flush,
                                    heads).items():
            fn, _, t = key.partition("@")
            row[f"launches_on_{path}_path"] = state[f"{path}_launches"][
                f"paged_attention.{fn}"]
            extra[f"{fn}@{tag}" + (f"_{t}" if t else "")] = row
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
