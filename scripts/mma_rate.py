#!/usr/bin/env python3
"""The card's throughput of one warp-level tensor-core instruction (card).

    python3 scripts/mma_rate.py [--iters N]

Builds a probe kernel (written below, compiled by ``nvcc`` for ``sm_90a``
into ``build/probe/``) in which every warp issues long runs of independent
``mma.sync`` instructions, 8 accumulators deep, and times it with CUDA
events: ``mma.sync.m16n8k8`` TF32 (the flash kernel's ``tf32x3`` path) and
``mma.sync.m16n8k16`` bf16 (its ``mma`` path), at 4 and 16 warps an SM.
Prints one JSON line per instruction and occupancy with the TFLOP/s reached
(2 flops a multiply-add), beside the card's name and power limit.  It
measures the ceiling of a kernel that issues nothing else; a kernel built
on the instruction cannot pass it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool TF32>
__global__ void probe(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u, b0 = a0 ^ 9u,
                 b1 = a0 ^ 11u;
  for (int n = 0; n < iters; ++n) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_probe(int tf32, float* out, int blocks, int threads, int iters, void* stream) {
  if (tf32)
    probe<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  else
    probe<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_rate.cu"
    src.write_text(_SRC)
    lib = out_dir / "mma_rate.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"mma_rate: nvcc failed\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096, help="loop trips a warp makes (8 mma each)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("mma_rate: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    lib = build()
    fn = lib.run_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tf32, name, flops in ((1, "mma.sync.m16n8k8.tf32", 2 * 16 * 8 * 8),
                              (0, "mma.sync.m16n8k16.bf16", 2 * 16 * 8 * 16)):
        for warps_per_sm in (4, 16):
            blocks, threads = sms * warps_per_sm // 4, 128
            out = torch.empty(blocks * threads, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def go():
                status = fn(tf32, out.data_ptr(), blocks, threads, args.iters, stream)
                if status:
                    raise RuntimeError(f"probe launch failed: CUDA error {status}")

            go()
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5):
                go()
            e.record()
            torch.cuda.synchronize()
            ms = s.elapsed_time(e) / 5
            total = blocks * 4 * args.iters * 8 * flops     # warps x instructions x flops
            print(json.dumps({"instruction": name, "warps_per_sm": warps_per_sm, "ms": ms,
                              "tflops": total / (ms * 1e-3) / 1e12}), flush=True)


if __name__ == "__main__":
    main()
