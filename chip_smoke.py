#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (written for an NVIDIA H100, sm_90a) and a checkout
of the repository: it puts ``<its dir>/src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package.  Phases, in order; any
failure raises and the script exits non-zero:

1. build   — compile the flash-attention and SSD chunk kernels from
             ``csrc/`` with nvcc, one process per source, in parallel; log
             ptxas's registers and spills per kernel, and the flash
             library's SASS tally of HGMMA (wgmma) and UTMALDG (TMA load)
             instructions, which must not be 0.
2. kernel  — each kernel against its plain PyTorch version on the card, in
             the model's strided layout: flash attention on the
             reference's test cases, the bf16 edges of the wgmma kernel
             (ragged, windowed, softcap, rows with no valid key, G = 7),
             both serving shapes (qwen2-7b 4x1024 D=128, zamba2-1.2b
             4x2048 D=64) and head dims 8 and 16; the SSD chunk kernel on
             the reference's SSD cases and both full-width prefill shapes.
             Times of kernel, plain version and (flash only)
             ``scaled_dot_product_attention``, a yardstick, beside each
             kernel's bound.
3. reduced — reduced qwen2-7b, qwen1.5-4b, mamba2-370m and zamba2-1.2b in
             f32, card against CPU, with each kernel's launches per prefill.
4. main    — full width from ``init_params(seed)``: qwen2-7b (prefill
             4x1024), then mamba2-370m and zamba2-1.2b (prefill 4x2048);
             each with 16 decode steps at B=4 and ``ServeEngine`` serving 8
             requests on 4 slots.  Launch counts are set to 0 before each
             model's run and read after it; every bf16 prefill attention
             launch must be a wgmma-kernel launch.
5. checks  — full width: qwen2-7b's kernel path against its plain path;
             prefill + decode against forward for all three, in f32 and
             bf16; mamba2-370m's kernel route against the step-by-step scan.
6. profile — device busy share, the top kernels and the port's own
             kernels of one prefill and one decode step of each model
             (``torch.profiler``).

The line before last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published dense peaks
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# tests/test_kernels_pallas.py FLASH_CASES, the serving shapes, the reduced
# configs' head dims, then the wgmma kernel's bf16 edges:
# B, Sq, Sk, H, KVH, D, causal, window, softcap, dtype
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 64, 64, 4, 4, 32, True, 0, 0.0, "float32"),
    (1, 100, 144, 4, 4, 64, True, 32, 0.0, "bfloat16"),
    (2, 64, 256, 8, 2, 128, False, 0, 0.0, "float32"),
    (1, 128, 128, 2, 1, 64, True, 0, 30.0, "float32"),
    (1, 32, 32, 4, 2, 64, True, 8, 0.0, "bfloat16"),
    (4, 1024, 1024, 28, 4, 128, True, 0, 0.0, "bfloat16"),   # qwen2-7b serving
    (2, 48, 48, 8, 2, 8, True, 0, 0.0, "float32"),           # qwen2-7b reduced
    (2, 48, 48, 4, 4, 16, True, 0, 0.0, "float32"),          # qwen1.5-4b reduced
    (4, 2048, 2048, 32, 32, 64, True, 0, 0.0, "bfloat16"),   # zamba2-1.2b serving
    (2, 64, 256, 8, 2, 128, False, 0, 0.0, "bfloat16"),      # cross attention
    (1, 128, 128, 2, 1, 64, True, 0, 30.0, "bfloat16"),      # softcap
    (1, 300, 40, 4, 2, 64, True, 16, 0.0, "bfloat16"),       # rows with no key
    (1, 200, 200, 28, 4, 128, True, 0, 0.0, "bfloat16"),     # G = 7, ragged
    (2, 333, 517, 8, 8, 128, False, 100, 20.0, "bfloat16"),  # window + softcap
]
MAIN_CASE = FLASH_CASES[6]
ZAMBA_CASE = FLASH_CASES[9]
BARS = {"float32": 2e-5, "bfloat16": 2e-2}    # the JAX kernel tests' bars

# tests/test_kernels_pallas.py SSD_CASES, the reduced configs' chunk, then
# the full-width prefill shapes: b, S, nh, P, N, chunk, x dtype
SSD_CASES = [
    (2, 128, 4, 16, 8, 32, "float32"),
    (1, 256, 2, 32, 16, 64, "float32"),
    (1, 96, 3, 8, 4, 32, "float32"),
    (2, 64, 4, 16, 8, 64, "bfloat16"),
    (2, 64, 8, 16, 16, 32, "float32"),            # mamba2 / zamba2 reduced
    (4, 2048, 32, 64, 128, 256, "bfloat16"),      # mamba2-370m prefill
    (4, 2048, 64, 64, 64, 256, "bfloat16"),       # zamba2-1.2b prefill
    (4, 2048, 32, 64, 128, 256, "float32"),       # mamba2-370m, f32 compute
]
SSD_MAIN_CASE = SSD_CASES[5]
SSD_TIMED = SSD_CASES[5:7]
SSD_BARS = {"float32": 1e-3, "bfloat16": 2e-2}   # the JAX SSD test's bars
KERNELS = ("flash", "flash_wgmma", "ssd")
# kernel launches one full-width bf16 prefill makes: flash once per
# attention layer or shared-block site, every one on the wgmma kernel, and
# SSD once per Mamba2 layer
MAIN_PREFILL_LAUNCHES = {
    "qwen2-7b": {"flash": 28, "flash_wgmma": 28, "ssd": 0},
    "mamba2-370m": {"flash": 0, "flash_wgmma": 0, "ssd": 48},
    "zamba2-1.2b": {"flash": 6, "flash_wgmma": 6, "ssd": 38},
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def attention_work(B, Sq, Sk, H, KVH, D, causal, window, dtype_bytes):
    """(operations, bytes) the function needs on these inputs: 4·D per
    valid (query, key) pair; q, k, v read once and o written once."""
    pairs = 0
    for qp in range(Sq):
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    flops = 4 * D * pairs * B * H
    nbytes = dtype_bytes * D * (2 * B * H * Sq + 2 * B * KVH * Sk)
    return flops, nbytes


def ssd_work(b, S, nh, P, N, chunk, x_bytes):
    """(operations, bytes) the SSD chunk function needs: C·Bᵀ once per
    (batch, chunk) on the T = L(L+1)/2 entries j <= i, and per head the
    two scalings of those entries, their product with x and the N x P
    state; x, B, C, dt and cum read once, y and the states written once."""
    L = min(chunk, S)
    nc = S // L
    T = L * (L + 1) // 2
    flops = b * nc * (2 * T * N + nh * (2 * T + 2 * T * P + 2 * L * N * P))
    nbytes = (x_bytes * b * S * nh * P + 4 * (2 * b * S * N + 2 * b * S * nh)
              + 4 * b * S * nh * P + 4 * b * nc * nh * N * P)
    return flops, nbytes


def bound(flops, nbytes, peak_flops):
    """(bound ms, what bounds it) on the published H100 peaks."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def counters():
    """(wrapper, counter attribute) of each launch count: all flash
    launches, the flash wgmma kernel's among them, the SSD kernel's."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_fwd
    return {"flash": (flash_attention_fwd, "launches"),
            "flash_wgmma": (flash_attention_fwd, "wgmma_launches"),
            "ssd": (ssd_chunk_fwd, "launches")}


def reset_launches() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def prefill_launches(cfg) -> dict:
    """Kernel launches one f32 prefill of a reduced config makes: flash
    once per attention layer (dense) or shared-block site (hybrid), all on
    the SIMT kernel; SSD once per Mamba2 layer."""
    from repro_torch.models.hybrid import n_shared_sites
    flash = (cfg.n_layers if cfg.family == "dense" else
             n_shared_sites(cfg) if cfg.family == "hybrid" else 0)
    return {"flash": flash, "flash_wgmma": 0,
            "ssd": 0 if cfg.family == "dense" else cfg.n_layers}


# --------------------------------------------------------------------- phases


def demangle(name: str) -> str:
    """A kernel's name as ptxas logs it, demangled by the toolkit's
    ``cu++filt``, e.g. ``<unnamed>::hopper::flash_fwd_wgmma<(int)128,
    (int)64>``."""
    from torch.utils.cpp_extension import CUDA_HOME
    return subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cu++filt"), "-p", name],
        capture_output=True, text=True, check=True).stdout.strip()


def sass_tally(path) -> dict:
    """Counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions in a
    built library's SASS (``cuobjdump -sass``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(path)],
        capture_output=True, text=True, check=True).stdout.splitlines()
    return {op: sum(op in line for line in sass)
            for op in ("HGMMA", "UTMALDG")}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    names = ("flash_attention", "ssd_chunk")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:    # one nvcc per source
        built = dict(zip(names, pool.map(_build.build, names)))
    for name, (path, seconds) in built.items():
        log("1 build", f"{name} built in {seconds:.2f} s -> "
            f"{os.path.relpath(path, HERE)}")
        kernel = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Function properties for" in line:
                kernel = demangle(line.split()[-1])
            elif "registers" in line or "spill" in line:
                log("1 build", f"ptxas {kernel}: " + line.strip())
    tally = sass_tally(built["flash_attention"][0])
    log("1 build", f"flash_attention SASS: {tally['HGMMA']} HGMMA (wgmma), "
        f"{tally['UTMALDG']} UTMALDG (TMA load) instructions")
    if not (tally["HGMMA"] and tally["UTMALDG"]):
        raise AssertionError("the flash library holds no wgmma or TMA load")
    log("1 build", f"all kernels built in {time.perf_counter() - t0:.2f} s")


def phase_kernel_flash(torch):
    """Every flash case against the plain version, q, k and v strided views
    of (B, S, heads, D) tensors as the model passes them; the two serving
    shapes timed.  Returns the kernel record: the qwen2-7b shape's numbers
    and, under ``zamba2_shape``, the zamba2-1.2b shape's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     kernel_route)
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {}
    for case in FLASH_CASES:
        B, Sq, Sk, H, KVH, D, causal, window, softcap, dname = case
        dt = getattr(torch, dname)
        q, k, v = (torch.randn(B, S, n, D, device="cuda", generator=gen)
                   .to(dt).transpose(1, 2)
                   for S, n in ((Sq, H), (Sk, KVH), (Sk, KVH)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        route = kernel_route(dt, D)
        before = flash_attention_fwd.wgmma_launches
        out = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        if flash_attention_fwd.wgmma_launches - before != (route == "wgmma"):
            raise AssertionError(f"{case}: the {route} route miscounted")
        want = attention_ref(q, k, v, **kw)
        err = float((out.float() - want.float()).abs().max())
        log("2 kernel", f"{case} {route}: max abs err {err:.3e} "
            f"(bar {BARS[dname]})")
        if not err < BARS[dname]:
            raise AssertionError(f"flash kernel disagrees on {case}: {err}")
        if case not in (MAIN_CASE, ZAMBA_CASE):
            continue
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), 20)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), 5)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20)
        flops, nbytes = attention_work(B, Sq, Sk, H, KVH, D, causal, window,
                                       q.element_size())
        peak = PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_F32_FLOPS
        bound_ms, bound_by = bound(flops, nbytes, peak)
        log("2 kernel", f"serving shape {case[:6]} {dname}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), kernel at {flops / ms / 1e9:.2f} "
            f"TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound")
        timed[case] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
    return {**timed[MAIN_CASE], "zamba2_shape": timed[ZAMBA_CASE]}


def ssd_inputs(torch, case, gen):
    """The kernel's inputs as the model hands them over: x a strided view
    of the conv output in its dtype, B and C f32 (views of an f32 conv
    output, copies of a bf16 one), dt and cum f32, A = -1."""
    b, S, nh, P, N, chunk, dname = case
    L = min(chunk, S)
    nc = S // L
    xbc = torch.randn(b, S, nh * P + 2 * N, device="cuda", generator=gen)
    xbc[..., nh * P:] *= 0.5
    xbc = xbc.to(getattr(torch, dname))
    x = xbc[..., :nh * P].reshape(b, nc, L, nh, P)
    B = xbc[..., nh * P:nh * P + N].float().reshape(b, nc, L, N)
    C = xbc[..., nh * P + N:].float().reshape(b, nc, L, N)
    dt = torch.nn.functional.softplus(
        torch.randn(b, nc, L, nh, device="cuda", generator=gen) - 1.0)
    cum = torch.cumsum(-dt, dim=2)
    return x, B, C, dt, cum


def phase_kernel_ssd(torch):
    from repro_torch.kernels.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_fwd

    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for case in SSD_CASES:
        args = ssd_inputs(torch, case, gen)
        y, states = ssd_chunk_fwd(*args)
        torch.cuda.synchronize()
        want_y, want_states = ssd_chunk_ref(*args)
        err = max(float((y - want_y).abs().max()),
                  float((states - want_states).abs().max()))
        dname = case[-1]
        log("2 kernel", f"ssd {case}: max abs err {err:.3e} "
            f"(bar {SSD_BARS[dname]})")
        if not err < SSD_BARS[dname]:
            raise AssertionError(f"SSD kernel disagrees on {case}: {err}")
        if case not in SSD_TIMED:
            continue
        ms = cuda_ms(lambda: ssd_chunk_fwd(*args), 20)
        plain_ms = cuda_ms(lambda: ssd_chunk_ref(*args), 5)
        flops, nbytes = ssd_work(*case[:6], args[0].element_size())
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS)
        log("2 kernel", f"ssd prefill shape {case}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, no single PyTorch call, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), kernel at "
            f"{flops / ms / 1e9:.2f} TFLOP/s")
        if case == SSD_MAIN_CASE:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": None, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    return result


def phase_reduced(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    rng = np.random.default_rng(0)
    # prompt lengths: the SSD takes S % chunk == 0 (chunk 32 here)
    for arch, S in (("qwen2-7b", 48), ("qwen1.5-4b", 48),
                    ("mamba2-370m", 64), ("zamba2-1.2b", 64)):
        cfg = get_config(arch, reduced=True).replace(
            compute_dtype="float32", param_dtype="float32")
        p_cpu = init_params(cfg, 0, device="cpu")
        p_gpu = tree_to(p_cpu, "cuda")
        toks = rng.integers(0, cfg.vocab_size, (2, S)).astype("int64")
        batch = {"tokens": torch.as_tensor(toks)}
        outs = {}
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            before = read_launches()
            with torch.inference_mode():
                cache, logits, pos = prefill(p, cfg, batch, pad_to=S + 8,
                                             device=dev)
                launched = {k: n - before[k]
                            for k, n in read_launches().items()}
                nxt = torch.argmax(logits, -1)[:, None]
                dlogits, _ = decode_step(p, cfg, cache, nxt, pos, device=dev)
            want = prefill_launches(cfg) if dev == "cuda" \
                else dict.fromkeys(KERNELS, 0)
            if launched != want:
                raise AssertionError(f"{arch} on {dev}: kernel launches in "
                                     f"prefill {launched}, want {want}")
            outs[dev] = (logits.cpu(), dlogits.cpu())
        rp = rel_err(outs["cuda"][0], outs["cpu"][0])
        rd = rel_err(outs["cuda"][1], outs["cpu"][1])
        log("3 reduced", f"{arch} f32, card vs CPU: prefill rel {rp:.3e}, "
            f"decode rel {rd:.3e} (bar 1e-4), kernel launches per prefill "
            f"{prefill_launches(cfg)}")
        if not (rp < 1e-4 and rd < 1e-4):
            raise AssertionError(f"{arch}: card and CPU disagree")


def phase_main(torch, cfg, params, S):
    """One model's main path: prefill B x S, 16 decode steps, ServeEngine.
    Returns the kernel launches of this run."""
    import numpy as np

    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import Request, ServeEngine

    B, steps = 4, 16
    tag = f"4 main {cfg.name}"
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    with torch.inference_mode():      # warm cuBLAS and the allocator
        prefill(params, cfg, {"tokens": tokens[:1, :256]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()                          # the main path starts here
    with torch.inference_mode():
        t0 = time.perf_counter()
        cache, logits, pos = prefill(params, cfg, {"tokens": tokens},
                                     pad_to=S + steps)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        in_prefill = read_launches()
        nxt = torch.argmax(logits, -1)[:, None]
        t0 = time.perf_counter()
        for _ in range(steps):
            dlogits, cache = decode_step(params, cfg, cache, nxt, pos)
            nxt = torch.argmax(dlogits, -1)[:, None]
            pos = pos + 1
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    del cache
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(2, 13))).astype(np.int32),
                    max_new_tokens=16) for _ in range(8)]
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=128)
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = read_launches()                # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del engine

    if in_prefill != MAIN_PREFILL_LAUNCHES[cfg.name]:
        raise AssertionError(f"{cfg.name}: prefill launched {in_prefill}, "
                             f"want {MAIN_PREFILL_LAUNCHES[cfg.name]}")
    for name, x in (("prefill", logits), ("decode", dlogits)):
        if x.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} logits: shape {tuple(x.shape)} "
                                 "or non-finite values")
    served = sum(len(r.out) for r in done)
    if not all(len(r.out) == 16 and r.done
               and all(0 <= t < cfg.vocab_size for t in r.out) for r in done):
        raise AssertionError("ServeEngine left a request short or out of vocab")
    log(tag, f"prefill {B}x{S}: {t_prefill:.4f} s "
        f"({B * S / t_prefill:.1f} tok/s), kernel launches {in_prefill}")
    log(tag, f"decode {steps} steps x {B}: {t_decode:.4f} s "
        f"({steps * B / t_decode:.2f} tok/s, "
        f"{t_decode / steps * 1e3:.2f} ms/step)")
    log(tag, f"ServeEngine 4 slots, max_len 128: {len(done)} requests, "
        f"{served} tokens in {t_serve:.3f} s ({served / t_serve:.2f} tok/s)")
    log(tag, f"peak memory {peak_gb:.2f} GB; launches on the main path "
        f"{launches}")
    return launches


def phase_checks(torch, cfg, params):
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.layers import unembed_matrix

    if cfg.family != "dense":
        return phase_checks_recurrent(torch, cfg, params)
    S = 512
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), device="cuda",
                         generator=gen)
    bars = {"float32": (1e-4, 2e-3), "bfloat16": (5e-2, 5e-2)}
    for cdt, (bar_plain, bar_decode) in bars.items():
        c = cfg.replace(compute_dtype=cdt)
        with torch.inference_mode():
            cache, logits, pos = prefill(params, c, {"tokens": toks[:, :S]},
                                         pad_to=S + 8)
            _, plain, _ = prefill(params, c.replace(attention_impl="naive"),
                                  {"tokens": toks[:, :S]})
            dlogits, _ = decode_step(params, c, cache, toks[:, S:], pos)
            h, _, _ = forward(params, c, {"tokens": toks})
            ref = h[:, -1, :].float() @ unembed_matrix(
                params["embedding"], c).float()
        r_plain, r_dec = rel_err(logits, plain), rel_err(dlogits, ref)
        agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
        log(f"5 checks {cfg.name}", f"{cdt}: prefill kernel path vs plain "
            f"path: rel {r_plain:.3e} (bar {bar_plain}, argmax agree {agree:.2f}); "
            f"prefill+decode vs forward(S+1): rel {r_dec:.3e} "
            f"(bar {bar_decode})")
        if not (r_plain < bar_plain and r_dec < bar_decode):
            raise AssertionError(f"full-width {cdt} check over its bar")


def phase_checks_recurrent(torch, cfg, params):
    """ssm / hybrid: prefill(S) + decode(token S) against forward.  The SSD
    takes S % chunk == 0, so forward runs 768 tokens and is read at
    position S = 512, which by causality sees tokens 0..S only."""
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.layers import unembed_matrix

    S, S_fwd = 512, 768
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, S_fwd), device="cuda",
                         generator=gen)
    for cdt, bar in (("float32", 2e-3), ("bfloat16", 5e-2)):
        c = cfg.replace(compute_dtype=cdt)
        with torch.inference_mode():
            cache, _, pos = prefill(params, c, {"tokens": toks[:, :S]},
                                    pad_to=S + 8)
            dlogits, _ = decode_step(params, c, cache, toks[:, S:S + 1], pos)
            h, _, _ = forward(params, c, {"tokens": toks})
            ref = h[:, S, :].float() @ unembed_matrix(
                params["embedding"], c).float()
        r_dec = rel_err(dlogits, ref)
        log(f"5 checks {cfg.name}", f"{cdt}: prefill({S})+decode vs "
            f"forward({S_fwd}) at {S}: rel {r_dec:.3e} (bar {bar})")
        if not r_dec < bar:
            raise AssertionError(f"full-width {cdt} check over its bar")


def phase_checks_scan(torch, cfg, params):
    """The kernel route of ``mamba_forward`` against ``impl="scan"`` (the
    step-by-step recurrence) on layer 0's input, in f32."""
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.ssm import mamba_forward
    from repro_torch.models.transformer import layer_params

    c = cfg.replace(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda",
                         generator=gen)
    p0 = layer_params(params["stack"]["layers"], 0)
    with torch.inference_mode():
        x = embed_tokens(params["embedding"], c, toks)
        got = mamba_forward(p0, c, x)
        want = mamba_forward(p0, c, x, impl="scan")
    err = float((got - want).abs().max())
    log(f"5 checks {cfg.name}", f"float32: layer 0 kernel route vs "
        f"step-by-step scan, S=512: max abs err {err:.3e} (bar 1e-3), rel "
        f"{rel_err(got, want):.3e}")
    if not err < 1e-3:
        raise AssertionError("the SSD kernel route disagrees with the scan")


def phase_profile(torch, cfg, params, S):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill

    B = 4
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                         generator=gen)
    with torch.inference_mode():
        cache, logits, pos = prefill(params, cfg, {"tokens": toks},
                                     pad_to=S + 4)
        nxt = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        work = {
            f"{cfg.name} prefill_4x{S}": lambda: prefill(
                params, cfg, {"tokens": toks}),
            f"{cfg.name} decode_step_4": lambda: decode_step(
                params, cfg, cache, nxt, pos),
        }
        for name, fn in work.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if getattr(e, "device_type", None) is not None
                       and str(e.device_type).endswith("CUDA")
                       and e.self_device_time_total > 0]
            dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            log("6 profile", f"{name}: wall {wall_ms:.2f} ms, device busy "
                f"{dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%), "
                f"{sum(e.count for e in kernels)} kernel launches")
            kernels.sort(key=lambda e: -e.self_device_time_total)
            # the six largest, then the port's own kernels below them
            for i, e in enumerate(kernels):
                if i >= 6 and not re.search(r"flash_fwd|ssd_chunk", e.key):
                    continue
                ms = e.self_device_time_total / 1e3
                log("6 profile", f"  {ms:9.3f} ms x{e.count:<5d} "
                    f"{100 * ms / max(dev_ms, 1e-9):5.1f}%  {e.key[:90]}")


def run_model(torch, arch, S):
    """Initialise one full-width model, drive its main path, check and
    profile it, and free it.  Returns the main path's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, 0)
    torch.cuda.synchronize()
    log(f"4 main {arch}", f"{param_count(params)} params "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB, "
        f"{cfg.param_dtype}) initialised on {torch.cuda.get_device_name(0)} "
        f"in {time.perf_counter() - t0:.2f} s")
    launches = phase_main(torch, cfg, params, S)
    phase_checks(torch, cfg, params)
    if cfg.family == "ssm":
        phase_checks_scan(torch, cfg, params)
    phase_profile(torch, cfg, params, S)
    del params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: repro_torch not found next to this script: run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    phase_build()
    kernel = {"flash": phase_kernel_flash(torch),
              "ssd": phase_kernel_ssd(torch)}
    phase_reduced(torch)

    launches = dict.fromkeys(KERNELS, 0)
    for arch, S in (("qwen2-7b", 1024), ("mamba2-370m", 2048),
                    ("zamba2-1.2b", 2048)):
        for k, n in run_model(torch, arch, S).items():
            launches[k] += n
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main paths never launched the {k} "
                                 "kernel")

    record = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:27",
         "launches": launches["flash"],
         "wgmma_launches": launches["flash_wgmma"], **kernel["flash"]},
        {"name": "ssd_chunk_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:21",
         "launches": launches["ssd"], **kernel["ssd"]},
    ]}
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
