#!/usr/bin/env python3
"""Check the logic of the f32 SIMT ring-step kernel on a machine with no card.

    python3 tools/simt_ring_cpu_check.py [B,C,H,KVH,Dh,q_off,k_off,causal,carry ...]

Compiles the SIMT section of ``csrc/flash_ring.cu`` (``ring_step_simt``,
with ``visible_tiles``, ``Carry`` and the ``Simt`` tiling of
``csrc/flash_common.cuh``) with g++ against the CUDA mock of
``tools/simt_bwd_cpu_check.py`` (and ``opaque`` of ``hopper.cuh`` as the
identity): a CTA runs as 256 ``std::thread``s,
``__syncthreads`` is a ``std::barrier``, a shuffle goes through a per-warp
buffer, ``cp.async`` is a synchronous 16-byte copy (so a copy issued into a
tile still being read shows as a wrong result), and shared memory starts as
garbage.  Each case runs ``ring_step_simt`` over the whole grid on seeded
f32 inputs and a carry ("random" o/m/l, or "dead": every third row's m at
-inf), the head dim padded and split as the wrapper and the C entry point
do, and holds o / l, m and l against ``flash_ring_step_plain`` at
chip_smoke's f32 ring tolerances (2e-5, 1e-4), rows that see no key
exactly.  It says nothing of registers, spills, bank conflicts or speed:
the card does.  Needs g++ with C++20; the build goes to a temporary
directory.
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
sys.path.insert(0, str(ROOT / "tools"))
from simt_bwd_cpu_check import MOCK  # noqa: E402
from tensorframes_tpu_torch.parallel import flash  # noqa: E402

O_TOL, ML_TOL = 2e-5, 1e-4  # chip_smoke.RING_O_TOL for f32, RING_ML_TOL
# every build width, causal and not, GQA, ragged chunks, the diagonal, cross
# offsets both ways, rows the chunk is hidden from, a hop hidden from every
# row, a dead carry, and a split head dim (640 padded to 1024, and 1024)
CASES = ["2,130,4,2,64,130,130,1,random", "1,200,4,2,64,300,0,1,dead",
         "1,130,2,2,128,100,200,1,dead", "1,100,2,1,128,0,100,0,random",
         "1,70,4,2,256,70,70,1,random", "1,40,2,2,256,0,200,1,random",
         "1,70,2,1,512,100,0,1,dead", "1,70,2,1,640,70,70,1,random",
         "1,40,2,2,1024,57,0,1,random"]

OPAQUE = "inline uint64_t opaque(uint64_t x) { return x; }  // hopper.cuh's, for the compiler\n"

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
void run(int B, int C, int H, int KVH, int W, int q_off, int k_off, int causal,
         float scale) {
  const int nc = W > SPLIT ? W / SPLIT : 1;
  auto q = readf("q.bin", size_t(B) * C * H * W), o = readf("o.bin", q.size());
  auto k = readf("k.bin", size_t(B) * C * KVH * W), v = readf("v.bin", k.size());
  auto m = readf("m.bin", size_t(B) * H * C), l = readf("l.bin", m.size());
  std::vector<float> o_out(o.size(), NAN), m_out(m.size(), NAN), l_out(l.size(), NAN);
  const Carry cy{o.data(), m.data(), l.data(), o_out.data(), m_out.data(), l_out.data()};
  const int64_t sq[3] = {int64_t(C) * H * W, int64_t(H) * W, W};
  const int64_t sk[3] = {int64_t(C) * KVH * W, int64_t(KVH) * W, W};
  dim3 g;
  g.x = (C + Simt<D>::BQ - 1) / Simt<D>::BQ; g.y = B * H; g.z = nc;
  launch(ring_step_simt<float, D>, g, q.data(), k.data(), v.data(), cy, H, KVH, C, C,
         causal, q_off, k_off, nc, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sk[0], sk[1],
         sk[2], scale);
  writef("o_out.bin", o_out); writef("m_out.bin", m_out); writef("l_out.bin", l_out);
}

int main(int argc, char** argv) {
  int a[8];
  for (int i = 0; i < 8; ++i) a[i] = std::atoi(argv[i + 1]);
  const float scale = std::atof(argv[9]);
  switch (std::min(a[4], SPLIT)) {
    case 64: run<64>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], scale); break;
    case 128: run<128>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], scale); break;
    case 256: run<256>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], scale); break;
    default: run<512>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], scale);
  }
  return 0;
}
"""


def _between(src: str, start: str, end: str) -> str:
    return src[src.index(start):src.index(end, src.index(start))]


def emulator_source() -> str:
    """The mock, flash_common.cuh's Simt, flash_ring.cu's visible_tiles,
    Carry and SIMT kernel, and the harness, as one C++ translation unit."""
    common = (ROOT / "tensorframes_tpu_torch/csrc/flash_common.cuh").read_text()
    ring = (ROOT / "tensorframes_tpu_torch/csrc/flash_ring.cu").read_text()
    simt = _between(common, "template <int D>\nstruct Simt {", "// The widest build.")
    head = _between(ring, "// How many key tiles of width bk", "// -------")
    kernel = _between(ring, "// flash_fwd.cu::flash_fwd_simt with the carry",
                      "template <int D>\ncudaError_t launch_simt")
    return MOCK + OPAQUE + simt + head + kernel + HARNESS


def check(exe: Path, work: Path, B, C, H, KVH, D, q_off, k_off, causal, carry) -> None:
    g = torch.Generator().manual_seed(D + q_off)
    q = torch.randn(B, C, H, D, generator=g)
    k, v = (torch.randn(B, C, KVH, D, generator=g) for _ in range(2))
    o = 3 * torch.randn(B, C, H, D, generator=g)
    m = torch.randn(B, H, C, generator=g)
    l = 1 + 49 * torch.rand(B, H, C, generator=g)
    if carry == "dead":
        m[:, :, ::3] = float("-inf")
    W = flash.kernel_head_dim(D)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("m", m), ("l", l)):
        x = flash.pad_head_dim(t, W) if t.dim() == 4 else t
        x.contiguous().numpy().tofile(work / f"{name}.bin")
    subprocess.run([str(exe), *map(str, (B, C, H, KVH, W, q_off, k_off, int(causal))),
                    repr(flash._scale(D))], cwd=work, check=True)
    got_o = torch.from_numpy(np.fromfile(work / "o_out.bin", np.float32)
                             .reshape(B, C, H, W)[..., :D].copy())
    got_m, got_l = (torch.from_numpy(np.fromfile(work / f"{n}_out.bin", np.float32)
                                     .reshape(B, H, C)) for n in ("m", "l"))
    ref_o, ref_m, ref_l = flash.flash_ring_step_plain(q, k, v, o, m, l, q_off, k_off, causal)
    if not torch.equal(torch.isneginf(got_m), torch.isneginf(ref_m)):
        raise AssertionError(f"{(B, C, H, KVH, D, q_off, k_off, causal, carry)}: "
                             "rows with m = -inf differ")
    dead = torch.isneginf(ref_m)
    if got_l[dead].any() or got_o.transpose(1, 2)[dead].any():
        raise AssertionError("a row that saw no key must carry l = 0 and o = 0")

    def per_l(x, den):
        return x / torch.where(den == 0, 1.0, den).transpose(1, 2)[..., None]

    errs = {}
    for name, a, b, tol in (("o/l", per_l(got_o, ref_l), per_l(ref_o, ref_l), O_TOL),
                            ("m", got_m[~dead], ref_m[~dead], ML_TOL),
                            ("l", got_l, ref_l, ML_TOL)):
        errs[name] = float((a - b).abs().max()) if a.numel() else 0.0
        if not torch.allclose(a, b, atol=tol, rtol=tol):
            raise AssertionError(f"{(B, C, H, KVH, D, q_off, k_off, causal, carry)} {name}: "
                                 f"max |diff| {errs[name]} beyond {tol}")
    print((B, C, H, KVH, D, q_off, k_off, causal, carry), errs, flush=True)


def main(argv) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "emu.cpp").write_text(emulator_source())
        subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                        "-o", str(work / "emu"), str(work / "emu.cpp")], check=True)
        for case in argv or CASES:
            *nums, carry = case.split(",")
            B, C, H, KVH, D, q_off, k_off, causal = map(int, nums)
            check(work / "emu", work, B, C, H, KVH, D, q_off, k_off, bool(causal), carry)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
