#!/usr/bin/env python3
"""Knock-out builds of the scan forwards: where their time goes.

    python3 chip_knockout.py     # from the root of a checkout; one card

Copies of a kernel source are patched as text, compiled into _proof/exp/
(git-ignored; one nvcc each, all started together, the program's flags)
and loaded with ctypes; nothing in the program changes. Each variant is
timed at the serving launch (L = 50, B = 256, H = 128, c4's serving shape,
`chip_smoke.layer_inputs`), as device time queued behind a GPU spin
(`chip_smoke.queued_ms`) and back to back.

1. "cuda_core_gru": the GRU forward's CUDA-core kernel (f32, the parity
   mode; bf16 off the mma's depth), at the CTA tile the wrapper gives it
   (two rows, 128 CTAs, Wh in shared memory), in bf16 and f32: why bf16
   read slower than f32. Variants: "program" (the program's own build),
   "base" (a copy whose CTAs record the SM they ran on: `%smid`),
   "one_cta_per_sm" (16 KB more shared memory a CTA, so two bf16 CTAs no
   longer fit on one SM), "shift_cvt" (bf16 → f32 by a 16-bit shift, exact
   as the cvt is), "both". Each is held bit for bit against the program's
   build, with its resident blocks per SM, its CTAs per SM and the
   instruction mix of its SASS.
2. "mma_lstm", "mma_gru": the bf16 tensor-core forwards. Variants: "base"
   (as built: σ and tanh from __expf and __fdividef), "exact_act" (from
   expf, tanhf and an IEEE division), "approx_act" (from
   tanh.approx.f32), "no_act" (σ, tanh replaced by affine maps),
   "split2" (each m-tile's product in two chains), "no_mma" (the step
   products skipped), "no_sync" (the step's barriers removed), "no_out"
   (no h_all stores). Only "base", "exact_act" and "split2" compute the
   contract, each printed with its largest difference from "base"; the
   others only time what is left.

The last line of the output is one JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "arec_torch", "csrc")
OUT = os.path.join(ROOT, "_proof", "exp")
L, B, H = 50, 256, 128
PAD = 16 * 1024

# ------------------------------------------------------------ patches ----
# (text in the source, its replacement, count expected (None: any > 0)),
# and a fourth item "scan_mma.cuh" for a patch of the shared header

SMID = ("  const int nt = blockDim.x;\n",
        "  const int nt = blockDim.x;\n  if (threadIdx.x == 0) {\n"
        "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
        "    exp_smid[blockIdx.x] = sm;\n  }\n", 1)
SMID_HEAD = ('#include "scan_mma.cuh"\n',
             '#include "scan_mma.cuh"\n__device__ unsigned exp_smid[4096];\n', 1)
PAD_SMEM = ("  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state;\n",
            f"  const size_t smem = (wh_in_smem ? H * G * welt : 0) + state + {PAD};\n",
            1)
SHIFT = ("  return __bfloat162float(x);\n",
         "  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16);\n",
         1)
SMID_TAIL = """
// resident CTAs per SM of the serving launch (BT = 2, Wh in shared memory)
// in bf16 and f32 with `pad` more bytes of shared memory, and the SM each
// CTA of the last launch ran on
extern "C" int exp_blocks_per_sm(int H, int pad, int* out) {
  const size_t state = 2 * kStateWords * static_cast<size_t>(H) * sizeof(float);
  const size_t wh = static_cast<size_t>(H) * 3 * H;
  const void* fns[2] = {
      reinterpret_cast<const void*>(gru_scan_fwd_kernel<__nv_bfloat16, 2, true, false>),
      reinterpret_cast<const void*>(gru_scan_fwd_kernel<float, 2, true, false>)};
  const size_t smem[2] = {wh * 2 + state + pad, wh * 4 + state + pad};
  for (int k = 0; k < 2; ++k) {
    const cudaError_t e = kernel_info(fns[k], 2 * H, smem[k], out + 4 * k);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

extern "C" int exp_smids(unsigned* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, exp_smid, n * sizeof(unsigned)));
}
"""


def act(sigmoid, tanh):
    """The tensor-core step's σ and tanh replaced (macros after the shared
    header)."""
    return ('#include "scan_mma.cuh"\n',
            '#include "scan_mma.cuh"\n'
            f"__device__ __forceinline__ float exp_sigmoid(float x) {{ {sigmoid} }}\n"
            f"__device__ __forceinline__ float exp_tanh(float x) {{ {tanh} }}\n"
            "#define fast_sigmoid exp_sigmoid\n#define fast_tanh exp_tanh\n", 1)


TANH_APPROX = ("float y; asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x)); "
               "return y;")
ACTS = {
    "exact_act": act("return 1.0f / (1.0f + expf(-x));", "return tanhf(x);"),
    "approx_act": act(
        "float y; asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(0.5f * x)); "
        "return 0.5f + 0.5f * y;", TANH_APPROX),
    "no_act": act("return 0.25f * x + 0.5f;", "return 0.5f * x;"),
}
NO_SYNC = ("    cp_async_wait_prev();      // step t+1's inputs are in\n"
           "    __syncthreads();\n",
           "    cp_async_wait_prev();      // step t+1's inputs are in\n", None)
SPLIT2 = ("  constexpr int NC = NM < 2 ? 2 : 1;", "  constexpr int NC = 2;", 1,
          "scan_mma.cuh")
NO_OUT = ("\n        const size_t out = (row0 + b) * H + j;\n        h_all[out] = hn;\n",
          "\n        const size_t out = (row0 + b) * H + j;\n", 1)


def skip(call, nm):
    """The products `call` replaced by accumulators read off the B
    fragments (so their loads stay)."""
    out = call.split("(a, bq, ")[1].rstrip(");\n")
    return (call, f"    for (int m = 0; m < {nm}; ++m)\n"
                  f"      for (int e = 0; e < 4; ++e) {out}[m][e] = "
                  f"__uint_as_float(bq[m][e] & 0x3f7fffffu);\n", 1)


EXPERIMENTS = {
    "cuda_core_gru": ("gru_scan_fwd", {
        "base": [SMID_HEAD, SMID],
        "one_cta_per_sm": [SMID_HEAD, SMID, PAD_SMEM],
        "shift_cvt": [SMID_HEAD, SMID, SHIFT],
        "both": [SMID_HEAD, SMID, PAD_SMEM, SHIFT]}),
    "mma_lstm": ("lstm_scan_fwd", {
        "base": [], **{k: [v] for k, v in ACTS.items()}, "split2": [SPLIT2],
        "no_mma": [skip("    mtile_products<0, 4>(a, bq, acc);\n", 4)],
        "no_sync": [NO_SYNC], "no_out": [NO_OUT]}),
    "mma_gru": ("gru_scan_fwd", {
        "base": [], **{k: [v] for k, v in ACTS.items()}, "split2": [SPLIT2],
        "no_mma": [skip("    mtile_products<0, 2>(a, bq, acc);\n", 2),
                   skip("    mtile_products<2, 1>(a, bq, an);\n", 1)],
        "no_sync": [NO_SYNC, ("    __syncthreads();\n\n    // n = tanh",
                              "\n    // n = tanh", 1)],
        "no_out": [NO_OUT]}),
}


def build_all():
    """{(experiment, variant): library path}, all compiled together."""
    sys.path.insert(0, ROOT)
    from arec_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for exp, (source, variants) in EXPERIMENTS.items():
        for name, patches in variants.items():
            inc = os.path.join(OUT, f"{exp}_{name}")
            os.makedirs(inc, exist_ok=True)
            texts = {f: open(os.path.join(CSRC, f)).read()
                     for f in (f"{source}.cu", "scan_mma.cuh")}
            for old, new, count, *target in patches:
                f = target[0] if target else f"{source}.cu"
                n = texts[f].count(old)
                assert n == count if count else n > 0, (exp, name, old, n)
                texts[f] = texts[f].replace(old, new)
            if exp == "cuda_core_gru":
                texts[f"{source}.cu"] += SMID_TAIL
            for f, text in texts.items():
                with open(os.path.join(inc, f), "w") as fh:
                    fh.write(text)
            so = os.path.join(OUT, f"lib{exp}_{name}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", so,
                   os.path.join(inc, f"{source}.cu")]
            procs[exp, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = so
    return libs


def sass_mix(so, pattern):
    """{kernel symbol matching `pattern`: {opcode: count}} in the SASS of
    library `so` ({} without cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    mix, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if re.search(pattern, fn) else None
            if fn:
                mix[fn] = {}
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            op = line.split("*/", 1)[1].strip().split()[0].rstrip(";")
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            op = op.split(".")[0]
            mix[fn][op] = mix[fn].get(op, 0) + 1
    return mix


def entry(lib, symbol, n_ptr, n_int):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from arec_torch.kernels import _build
    from chip_smoke import cuda_ms, layer_inputs, queued_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = build_all()
    _build.build(["gru_scan_fwd"])
    stream = torch.cuda.current_stream().cuda_stream
    results = {exp: {} for exp in EXPERIMENTS}

    def timed(call):
        call()
        torch.cuda.synchronize()
        return {"ms": queued_ms([call]), "back_to_back_ms": cuda_ms(call, 50)}

    # 1. the CUDA-core GRU forward, bf16 and f32, two rows a CTA
    xw, wh, mask, h0 = layer_inputs(L, B, H, dev, seed=B, cell="gru")
    ref = {}
    variants = {"program": str(_build.library_path("gru_scan_fwd")),
                **{v: libs["cuda_core_gru", v]
                   for v in EXPERIMENTS["cuda_core_gru"][1]}}
    for name, so in variants.items():
        lib = ctypes.CDLL(so)
        fn = entry(lib, "gru_scan_fwd", 5, 6)
        res = {"sass": {
            "bfloat16" if "bfloat16Li2" in k else "float32":
                {op: n for op, n in sorted(m.items(), key=lambda kv: -kv[1])}
            for k, m in sass_mix(
                so, r"gru_scan_fwd_kernelI.*Li2ELb1ELb0E").items()}}
        if name != "program":
            info = (ctypes.c_int * 8)()
            pad = PAD if name in ("one_cta_per_sm", "both") else 0
            assert lib.exp_blocks_per_sm(H, pad, info) == 0
            res["blocks_per_sm"] = {"bfloat16": info[3], "float32": info[7]}
            res["registers"] = {"bfloat16": info[0], "float32": info[4]}
        for dt in ("bfloat16", "float32"):
            w = wh.to(getattr(torch, dt)).contiguous()
            out = torch.empty(L, B, H, device=dev)

            def call():
                assert fn(xw.data_ptr(), w.data_ptr(), mask.data_ptr(),
                          h0.data_ptr(), out.data_ptr(), L, B, H,
                          int(dt == "bfloat16"), 2, 1, stream) == 0
            res[dt] = timed(call)
            if name == "program":
                ref[dt] = out.clone()
            else:
                call()
                torch.cuda.synchronize()
                smid = (ctypes.c_uint * (B // 2))()
                assert lib.exp_smids(smid, B // 2) == 0
                per_sm = {}
                for s in smid:
                    per_sm[s] = per_sm.get(s, 0) + 1
                res[dt].update(sms_used=len(per_sm), sms_with_2_ctas=sum(
                    n > 1 for n in per_sm.values()))
            assert torch.equal(out, ref[dt]), (name, dt, "not bit for bit")
            print(f"cuda_core_gru {name} {dt}: {res[dt]}", flush=True)
        results["cuda_core_gru"][name] = res

    # 2. the bf16 tensor-core forwards' serving launch
    for exp, cell, symbol, n_ptr in (("mma_lstm", "lstm", "lstm_scan_fwd_bf16",
                                      7),
                                     ("mma_gru", "gru", "gru_scan_fwd_bf16",
                                      5)):
        args = layer_inputs(L, B, H, dev, seed=B, cell=cell)
        xw, wh, mask, h0 = args[:4]
        wt = wh.t().to(torch.bfloat16, memory_format=torch.contiguous_format)
        outs = [torch.empty(L, B, H, device=dev)] + (
            [torch.empty(B, H, device=dev)] if cell == "lstm" else [])
        ptrs = [t.data_ptr() for t in (xw, wt, mask, *args[3:], *outs)]
        base = None
        for name in EXPERIMENTS[exp][1]:
            fn = entry(ctypes.CDLL(libs[exp, name]), symbol, n_ptr, 3)

            def call():
                assert fn(*ptrs, L, B, H, stream) == 0
            res = timed(call)
            if name in ("base", "exact_act", "split2"):
                call()
                torch.cuda.synchronize()
                if base is None:
                    base = outs[0].clone()
                res["max_abs_diff_from_base"] = float(
                    (outs[0] - base).abs().max())
            results[exp][name] = res
            print(f"{exp} {name}: {res}", flush=True)
    print(card)
    print(json.dumps({"card": card, "shape": f"L={L} B={B} H={H}",
                      **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
