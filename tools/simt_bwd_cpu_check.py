#!/usr/bin/env python3
"""Check the logic of the f32 SIMT backward kernels on a machine with no card.

    python3 tools/simt_bwd_cpu_check.py [B,Lq,Lk,H,KVH,Dh,causal ...]

Compiles the SIMT section of ``csrc/flash_bwd.cu`` (``SimtBwd`` through
``flash_bwd_dkv_simt``) with g++ against a mock of the CUDA built-ins it
uses: a CTA runs as 256 ``std::thread``s, ``__syncthreads`` is a
``std::barrier``, a shuffle goes through a per-warp buffer, ``cp.async`` is
a synchronous 16-byte copy (so a copy issued into a tile still being read
shows as a wrong result), and shared memory starts as garbage. Each case
runs ``flash_bwd_dq_simt`` and ``flash_bwd_dkv_simt`` over the whole grid
on seeded f32 inputs (the head dim padded and split as the wrapper and the
C entry points do) and holds dQ, dK and dV against ``flash_bwd_dq_plain``
/ ``flash_bwd_dkv_plain`` at chip_smoke's f32 backward tolerance (2e-4).
It says nothing of registers, spills, bank conflicts or speed: the card
does. Needs g++ with C++20; the build goes to a temporary directory.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tensorframes_tpu_torch.parallel import flash  # noqa: E402

TOL = 2e-4  # chip_smoke.BWD_TOL for f32
# every build width, causal and not, GQA, ragged and cross lengths both
# ways, and a split head dim (640 padded to 1024, and 1024)
CASES = ["2,130,130,4,2,128,1", "1,200,330,4,2,128,1", "1,300,140,2,1,64,0",
         "1,33,200,2,1,64,1", "1,130,300,2,2,256,0", "1,257,257,4,2,256,1",
         "1,100,100,2,1,512,1", "1,100,60,2,1,640,1", "1,70,70,2,1,1024,0"]

MOCK = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x)
#define __shared__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
thread_local dim3 threadIdx, blockIdx;
dim3 gridDim;
float smem_f[60000];  // above every SimtBwd<...>::SMEM / 4
std::barrier<>* cta_bar;
std::barrier<>* warp_bar[8];
float shfl_buf[8][32];
inline void __syncthreads() { cta_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  shfl_buf[w][l] = v;
  warp_bar[w]->arrive_and_wait();
  const float r = shfl_buf[w][l ^ off];
  warp_bar[w]->arrive_and_wait();
  return r;
}
using std::min;
constexpr int SPLIT = 512;
inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
"""

HARNESS = r"""
template <typename K, typename... A>
void launch(K kernel, dim3 grid, A... a) {
  gridDim = grid;
  std::barrier<> bar(256);
  cta_bar = &bar;
  for (auto& w : warp_bar) w = new std::barrier<>(32);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::memset(smem_f, 0x7f, sizeof(smem_f));  // garbage: ~3.4e38 where unwritten
        std::vector<std::thread> th;
        for (int t = 0; t < 256; ++t)
          th.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx.x = x; blockIdx.y = y; blockIdx.z = z;
            kernel(a...);
          });
        for (auto& h : th) h.join();
      }
  for (auto& w : warp_bar) delete w;
}

std::vector<float> readf(const char* path, size_t n) {
  std::vector<float> v(n);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), 4, n, f) != n) std::exit(2);
  std::fclose(f);
  return v;
}

void writef(const char* path, const std::vector<float>& v) {
  FILE* f = std::fopen(path, "wb");
  std::fwrite(v.data(), 4, v.size(), f);
  std::fclose(f);
}

template <int D>
void run(int B, int Lq, int Lk, int H, int KVH, int W, int causal, float scale) {
  const int nc = W > SPLIT ? W / SPLIT : 1;
  auto q = readf("q.bin", size_t(B) * Lq * H * W), dout = readf("do.bin", q.size());
  auto k = readf("k.bin", size_t(B) * Lk * KVH * W), v = readf("v.bin", k.size());
  auto lse = readf("lse.bin", size_t(B) * H * Lq), delta = readf("delta.bin", lse.size());
  Problem p{q.data(), k.data(), v.data(), dout.data(), lse.data(), delta.data(),
            H, KVH, Lq, Lk, causal, scale, {}};
  const int64_t sq[3] = {int64_t(Lq) * H * W, int64_t(H) * W, W};
  const int64_t sk[3] = {int64_t(Lk) * KVH * W, int64_t(KVH) * W, W};
  for (int i = 0; i < 3; ++i) {
    p.s.q[i] = p.s.d[i] = sq[i];
    p.s.k[i] = p.s.v[i] = sk[i];
  }
  std::vector<float> dq(q.size(), NAN), dk(k.size(), NAN), dv(v.size(), NAN);
  dim3 g;
  g.x = (Lq + DqSimt<D>::R - 1) / DqSimt<D>::R; g.y = B * H; g.z = nc;
  launch(flash_bwd_dq_simt<float, D>, g, p, nc, dq.data());
  g.x = (Lk + DkvSimt<D>::R - 1) / DkvSimt<D>::R; g.y = B * KVH;
  launch(flash_bwd_dkv_simt<float, D>, g, p, nc, dk.data(), dv.data());
  writef("dq.bin", dq); writef("dk.bin", dk); writef("dv.bin", dv);
}

int main(int argc, char** argv) {
  int a[7];
  for (int i = 0; i < 7; ++i) a[i] = std::atoi(argv[i + 1]);
  const float scale = std::atof(argv[8]);
  switch (std::min(a[5], SPLIT)) {
    case 64: run<64>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], scale); break;
    case 128: run<128>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], scale); break;
    case 256: run<256>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], scale); break;
    default: run<512>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], scale);
  }
  return 0;
}
"""


def emulator_source() -> str:
    """The mock, flash_bwd.cu's Problem and safe_lse, its SIMT section, and
    the harness, as one C++ translation unit."""
    src = (ROOT / "tensorframes_tpu_torch/csrc/flash_bwd.cu").read_text()
    start = src.rfind("// ----", 0, src.index("// f32: the register-tiled SIMT kernels"))
    end = src.rfind("// ----", 0, src.index("// launch\n"))
    pre = src[src.index("// element strides (batch, length, head)"):
              src.index("// ---------------------------------------------------------------------------\n"
                        "// bf16 and f16")]
    return MOCK + pre + src[start:end] + HARNESS


def check(exe: Path, work: Path, B, Lq, Lk, H, KVH, D, causal) -> None:
    g = torch.Generator().manual_seed(D)
    q, do = (torch.randn(B, Lq, H, D, generator=g) for _ in range(2))
    k, v = (torch.randn(B, Lk, KVH, D, generator=g) for _ in range(2))
    out, lse = flash.flash_attention_plain(q, k, v, causal)
    W = flash.kernel_head_dim(D)
    pq, pk, pv, pout, pdo = (flash.pad_head_dim(x, W) for x in (q, k, v, out, do))
    delta = (pdo * pout).sum(-1).transpose(1, 2)
    for name, t in (("q", pq), ("k", pk), ("v", pv), ("do", pdo), ("lse", lse), ("delta", delta)):
        t.contiguous().numpy().tofile(work / f"{name}.bin")
    subprocess.run([str(exe), *map(str, (B, Lq, Lk, H, KVH, W, int(causal))),
                    repr(flash._scale(D))], cwd=work, check=True)
    refs = (flash.flash_bwd_dq_plain(q, k, v, out, lse, do, causal),
            *flash.flash_bwd_dkv_plain(q, k, v, out, lse, do, causal))
    errs = {}
    for name, ref, like in zip(("dq", "dk", "dv"), refs, (pq, pk, pv)):
        got = np.fromfile(work / f"{name}.bin", np.float32).reshape(like.shape)[..., :D]
        errs[name] = float(np.abs(got - ref.numpy()).max())
        if not np.allclose(got, ref.numpy(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{(B, Lq, Lk, H, KVH, D, causal)} {name}: "
                                 f"max |diff| {errs[name]} beyond {TOL}")
    print((B, Lq, Lk, H, KVH, D, causal), errs, flush=True)


def main(argv) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "emu.cpp").write_text(emulator_source())
        subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                        "-o", str(work / "emu"), str(work / "emu.cpp")], check=True)
        for case in argv or CASES:
            B, Lq, Lk, H, KVH, D, causal = map(int, case.split(","))
            check(work / "emu", work, B, Lq, Lk, H, KVH, D, bool(causal))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
