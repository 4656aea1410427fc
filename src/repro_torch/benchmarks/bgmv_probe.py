"""Where a BGMV launch spends its time on the card (diagnosis, not a
benchmark row).

Builds edited copies of ``csrc/qrlora_bgmv.cu`` into ``_build/probe/`` and
times them at the serve's shapes (bf16, K = 576, r = 128, 8 slots; wq and
wv at 4 decode lanes, wq at a 64-row bucket), by CUDA-graph replay:

* ``--trace``: a copy that stamps ``%globaltimer`` from thread 0 of every
  CTA at each phase boundary of the one-launch kernel; prints, per phase,
  the min / mean / max µs after the first CTA started, and the replay time
  of an empty kernel of the same cluster grid (the launch floor);
* ``--variants``: copies with one phase left out each (the mma loop; the
  staging of x, W and B; B and its column tiles; the λ rows; everything
  after the first cluster barrier), without the register cap, and with the
  mma loop that re-loaded x's fragment for every 16 × 8 tile, each timed
  twice in turns.  A left-out phase gives wrong numbers: only the times
  mean anything.

    PYTHONPATH=src python -m repro_torch.benchmarks.bgmv_probe [--trace] [--variants]

The edits match the source's text; a changed source fails them loudly.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from repro_torch.benchmarks.common import graph_ms
from repro_torch.kernels import _build

SHAPES = ((4, 576), (4, 192), (64, 576))  # (M, N) at K = 576, r = 128
PHASES = ("start", "copies issued", "λ loaded", "copies landed", "mma done", "partials sent",
          "barrier 1", "P·A sent", "barrier 2")
_OUT = _build.BUILD_DIR / "probe"
_STAMP = ('{ unsigned long long _t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(_t)); '
          'if (threadIdx.x == 0) g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + ID] = _t; }')
# the mma loop before its fragments were shared (x re-loaded for every tile)
_TILE_LOOP = """  if constexpr (kMma) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_tiles = TN / 8 + g.rp / 8, items = ceil_div(tm, 16) * n_tiles;
    constexpr int ITEMS = ceil_div(ceil_div(TM, 16) * (TN + R_MAX) / 8, THREADS / 32);
    float acc[ITEMS][4] = {};
    for (int kc0 = k0; kc0 < k1; kc0 += g.kc) {
      const int kn = min(g.kc, k1 - kc0);
      stage<2>(smem, g.xs, x + (size_t)m0 * K + kc0, K, ceil_div(tm, 16) * 16, g.kx, tm, kn, vec);
      stage<2>(smem + g.o_w, g.ws, W + (size_t)kc0 * N + n0, N, g.kx, TN, kn, N - n0, vec);
      stage<2>(smem + g.o_b, g.bs, B + (size_t)kc0 * r, r, g.kx, g.rp, kn, r, vec);
      if (kc0 == k0) stage_a_and_lam();
      cp_async_wait_all();
      __syncthreads();
      for (int k = 0; k < kn; k += 16) {
#pragma unroll
        for (int t = 0; t < ITEMS; ++t) {
          const int item = warp + t * (THREADS / 32);
          if (item < items) {
            const int mt = item / n_tiles, nt = item % n_tiles;
            uint32_t a[4], b[2];
            ldsm_x4(a, smem + (mt * 16 + lane % 16) * g.xs + (k + lane / 16 * 8) * 2);
            if (nt < TN / 8)
              ldsm_x2_trans(b, smem + g.o_w + (k + lane % 16) * g.ws + nt * 16);
            else
              ldsm_x2_trans(b, smem + g.o_b + (k + lane % 16) * g.bs + (nt - TN / 8) * 16);
            mma_bf16(acc[t], a, b);
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait_all();
    cluster_wait();
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int item = warp + t * (THREADS / 32);
      if (item < items) {
        const int mt = item / n_tiles, nt = item % n_tiles, c = lane % 4 * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + lane / 4 + 8 * h;
          const float2 v = make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
          if (m >= tm) continue;
          if (nt < TN / 8) {
            const int n = nt * 8 + c;
            st_cluster(recv_w + (rank * g.tm + m) * OUT + n % OUT, n / OUT, v);
          } else {
            const int j = (nt - TN / 8) * 8 + c;
            if (j < r) st_cluster(recv_b + (rank * g.tm + m) * g.js + j % g.js, j / g.js, v);
          }
        }
      }
    }
"""


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the source no longer holds {old[:70]!r}")
    return src.replace(old, new, 1)


def _before(src: str, anchor: str, text: str) -> str:
    return _sub(src, anchor, text + anchor)


def _traced(src: str) -> str:
    stamp = lambda i: "  " + _STAMP.replace("ID", str(i)) + "\n"
    src = _sub(src, '#include "cluster.cuh"',
               '#include "cluster.cuh"\n__device__ unsigned long long g_stamp[1 << 16];')
    src = _before(src, "  cluster_arrive_relaxed();  // peers write", stamp(0))
    src = _before(src, "      if (kc0 == k0) stage_a_and_lam();", stamp(1))
    src = _sub(src, "      if (kc0 == k0) stage_a_and_lam();\n",
               "      if (kc0 == k0) stage_a_and_lam();\n" + stamp(2))
    src = _before(src, "      for (int k = 0; k < kn; k += 16) {", stamp(3))
    src = _before(src, "    cluster_wait();", stamp(4))
    src = _sub(src, "  cluster_sync();\n\n  // P over",
               stamp(5) + "  cluster_sync();\n" + stamp(6) + "\n  // P over")
    src = _before(src, "  cluster_sync();  // no shared memory", stamp(7))
    src = _before(src, "  // this rank's 4 columns: both sums", stamp(8))
    return _sub(src, 'extern "C" const char* qrlora_bgmv_error_string', '''
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(THREADS) probe_empty(int) {
  cluster_arrive_relaxed();
  cluster_wait();
  cluster_sync();
}
extern "C" int probe_empty_launch(int ctas, cudaStream_t s) {
  probe_empty<<<ctas, THREADS, 0, s>>>(0);
  return (int)cudaGetLastError();
}
extern "C" int probe_stamps(unsigned long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n * sizeof(unsigned long long));
}
extern "C" const char* qrlora_bgmv_error_string''')


def _variants(src: str) -> dict:
    mma = src[src.index("  if constexpr (kMma) {\n"):src.index("  } else {\n    // float32")]
    no_b = _sub(src, "      stage<2>(smem + g.o_b, g.bs, B + (size_t)kc0 * r, r, g.kx, g.rp, kn, r, "
                     "vec);\n", "")
    return {
        "kernel": src,
        "tile_loop": _sub(src, mma, _TILE_LOOP),
        "no_mma": _sub(src, "for (int k = 0; k < kn; k += 16) {", "for (int k = 0; k < 0; k += 16) {"),
        "no_stage": _sub(_sub(_sub(
            src, "      stage<2>(smem, g.xs, x + (size_t)m0 * K + kc0, K, m_tiles * 16, g.kx, tm, "
                 "kn, vec);\n", ""),
            "      if constexpr (kQuant)\n"
            "        stage<1>(smem + g.o_q, g.qs, W + (size_t)kc0 * N + n0, N, g.kx, TN, kn, "
            "N - n0, vec);\n      else\n"
            "        stage<2>(smem + g.o_w, g.ws, W + (size_t)kc0 * N + n0, N, g.kx, TN, kn, "
            "N - n0, vec);\n", ""),
            "      stage<2>(smem + g.o_b, g.bs, B + (size_t)kc0 * r, r, g.kx, g.rp, kn, r, vec);\n",
            ""),
        "no_B": _sub(no_b, "const int n_tiles = TN / 8 + g.rp / 8, m_tiles",
                     "const int n_tiles = TN / 8, m_tiles"),
        "no_lam": _sub(src, "      if (kc0 == k0) stage_a_and_lam();\n", ""),
        "no_tail": _sub(src, "  cluster_sync();\n\n  // P over",
                        "  cluster_sync();\n  if (M > 0) return;\n\n  // P over"),
        "no_cap": _sub(src, "__launch_bounds__(THREADS, std::is_same<TX, bf16>::value ? 3 : 1)",
                       "__launch_bounds__(THREADS)"),
    }


def _build_all(sources: dict) -> dict:
    """name → loaded library, one nvcc each, all at once."""
    _OUT.mkdir(parents=True, exist_ok=True)
    csrc = _build._CSRC
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, _OUT / header.name)
    procs = {}
    for name, src in sources.items():
        (_OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(_OUT / f"{name}.so"),
             str(_OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(_OUT / f"{name}.so"))
        lib.qrlora_bgmv_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    return libs


def _operands(gen, M, N, K=576, r=128, n_slots=8):
    dev = gen.device
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).bfloat16()
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev) * 0.3
    seg = torch.randint(0, n_slots, (M,), generator=gen, device=dev, dtype=torch.int32)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    return x, W, B, A, lam, seg, y


def _call(lib, ops, M, N, K=576, r=128, n_slots=8):
    x, W, B, A, lam, seg, y = ops
    return lambda: lib.qrlora_bgmv_launch(
        x.data_ptr(), W.data_ptr(), B.data_ptr(), A.data_ptr(), lam.data_ptr(), seg.data_ptr(),
        y.data_ptr(), M, K, N, r, n_slots, 1.0, 1, torch.cuda.current_stream().cuda_stream)


def trace(gen) -> None:
    lib = _build_all({"traced": _traced((_build._CSRC / "qrlora_bgmv.cu").read_text())})["traced"]
    lib.probe_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for M, N in SHAPES:
        call = _call(lib, _operands(gen, M, N), M, N)
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        ctas = -(-N // 32) * 8 * -(-M // 32)
        buf = (ctypes.c_ulonglong * (ctas * 16))()
        if lib.probe_stamps(buf, ctas * 16):
            raise RuntimeError("reading the stamps failed")
        t0 = min(buf[c * 16] for c in range(ctas))
        print(f"M={M} N={N}, {ctas} CTAs, graph replay {graph_ms(call):.5f} ms; µs after the "
              "first CTA's start (min / mean / max over CTAs):")
        for i, phase in enumerate(PHASES):
            v = [(buf[c * 16 + i] - t0) / 1e3 for c in range(ctas)]
            print(f"  {phase:14s} {min(v):7.2f} {sum(v) / ctas:7.2f} {max(v):7.2f}")
    for ctas in (144, 48):
        empty = lambda: lib.probe_empty_launch(ctas, torch.cuda.current_stream().cuda_stream)
        print(f"empty cluster kernel, {ctas} CTAs: graph replay {graph_ms(empty):.5f} ms")


def variants(gen) -> None:
    libs = _build_all(_variants((_build._CSRC / "qrlora_bgmv.cu").read_text()))
    for M, N in SHAPES:
        ops = _operands(gen, M, N)
        times = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                times[name].append(round(graph_ms(_call(lib, ops, M, N)), 5))
        print(f"M={M} N={N} graph replay ms: {times}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bgmv_probe needs the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(torch.cuda.get_device_name(0))
    if args.trace or not args.variants:
        trace(gen)
    if args.variants or not args.trace:
        variants(gen)


if __name__ == "__main__":
    main()
