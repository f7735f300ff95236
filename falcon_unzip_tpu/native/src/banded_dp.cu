// Banded edit-distance DP for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (ops/cuda_align.py builds and loads it).
//
// Semantics are those of ops/banded_align.py::banded_align_batch (and of
// oracle/align.py::banded_dp): the same slope-1/2 band of fixed width W,
// the same tie rules, and the same int8 (Dmax, P, W) backpointer layout,
// so traceback_batch reads the result unchanged.
//
// Design: one warp per pair. Lane l holds the C = W/32 contiguous band
// cells [l*C, l*C + C) of the last two antidiagonals in registers, so the
// whole band stays on chip for the run of Dmax antidiagonals. The band
// shift between antidiagonals is data-independent (band_lo), so the
// +-1 neighbours come from a warp-uniform select over the lane's own cells
// and one __shfl_up/__shfl_down per antidiagonal. The guarded query and
// reversed target rows are staged once in shared memory. Each
// antidiagonal's backpointers leave as one C-byte store per lane: a
// coalesced W-byte row of bp[d, p, :].
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kInf = 1 << 20;  // oracle.align.INF
constexpr int kGlobal = 0;
constexpr int kQgLocal = 1;
constexpr int kTgLocal = 2;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int band_lo(int d, int W) {
  const int lo = (d + 1) / 2 - W / 2;
  return lo > 0 ? lo : 0;
}

template <int C>
__device__ __forceinline__ void store_moves(int8_t* dst,
                                            const uint32_t (&w)[(C + 3) / 4]) {
  if constexpr (C == 1) {
    *reinterpret_cast<uint8_t*>(dst) = static_cast<uint8_t>(w[0]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(w[0]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    static_assert(C == 16, "band width must be 32 * {1, 2, 4, 8, 16}");
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int C, int MODE>
__global__ void __launch_bounds__(32) banded_dp_kernel(
    const int8_t* __restrict__ qg, const int8_t* __restrict__ trg,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int P, int LQG, int LTG, int Lt, int G, int Dmax,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_i,
    int32_t* __restrict__ end_j, int8_t* __restrict__ bp) {
  constexpr int W = 32 * C;
  extern __shared__ int4 smem_rows[];
  const int lane = threadIdx.x;
  const int p = blockIdx.x;

  // stage this pair's guarded rows (LQG, LTG are multiples of 16)
  int4* sq4 = smem_rows;
  int4* st4 = smem_rows + LQG / 16;
  const int4* gq4 = reinterpret_cast<const int4*>(qg + (size_t)p * LQG);
  const int4* gt4 = reinterpret_cast<const int4*>(trg + (size_t)p * LTG);
  for (int x = lane; x < LQG / 16; x += 32) sq4[x] = gq4[x];
  for (int x = lane; x < LTG / 16; x += 32) st4[x] = gt4[x];
  __syncwarp();
  const int8_t* sq = reinterpret_cast<const int8_t*>(sq4);
  const int8_t* st = reinterpret_cast<const int8_t*>(st4);

  const int n = n_arr[p];
  const int m = m_arr[p];
  const int w0 = lane * C;

  int32_t V1[C], V2[C];  // antidiagonals d-1 and d-2, band frame of each
#pragma unroll
  for (int k = 0; k < C; ++k) V1[k] = V2[k] = kInf;
  int32_t best = kInf, best_j = -1, final_v = kInf;
  int lo1 = 0, lo2 = 0;
  const size_t bp_stride = (size_t)P * W;
  int8_t* bp_lane = bp + (size_t)p * W + w0;

  for (int d = 0; d < Dmax; ++d) {
    const int lo = band_lo(d, W);
    const bool s1 = lo != lo1;  // shift vs d-1, in {0, 1}
    const bool s2 = lo != lo2;  // shift vs d-2, in {0, 1}
    int32_t v1_prev = __shfl_up_sync(kFull, V1[C - 1], 1);
    int32_t v2_prev = __shfl_up_sync(kFull, V2[C - 1], 1);
    int32_t v1_next = __shfl_down_sync(kFull, V1[0], 1);
    if (lane == 0) v1_prev = v2_prev = kInf;
    if (lane == 31) v1_next = kInf;

    const int i0 = lo + w0;
    const int8_t* qrow = sq + i0;               // q[i-1] == qg[i]
    const int8_t* trow = st + (G + Lt - d + i0);  // t[j-1] == trg[G+Lt-j]
    uint32_t words[(C + 3) / 4];
#pragma unroll
    for (int x = 0; x < (C + 3) / 4; ++x) words[x] = 0;
    int32_t Vn[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int i = i0 + k;
      const int j = d - i;
      const int32_t v1m = k > 0 ? V1[k - 1] : v1_prev;
      const int32_t v1p = k < C - 1 ? V1[k + 1] : v1_next;
      const int32_t v2m = k > 0 ? V2[k - 1] : v2_prev;
      const int32_t up = s1 ? V1[k] : v1m;      // (i-1, j)
      const int32_t left = s1 ? v1p : V1[k];    // (i, j-1)
      const int32_t diag = s2 ? V2[k] : v2m;    // (i-1, j-1)
      const int qi = qrow[k];
      const int tj = trow[k];
      const int32_t sub = (qi == tj && qi < 4) ? 0 : 1;
      const int32_t cd = (i >= 1 && j >= 1) ? diag + sub : kInf;
      const int32_t cu = i >= 1 ? up + 1 : kInf;
      const int32_t cl = j >= 1 ? left + 1 : kInf;
      int32_t v = min(min(cd, cu), cl);
      const uint32_t mv = cd <= v ? 0u : (cu <= v ? 1u : 2u);
      const bool origin =
          MODE == kTgLocal ? (i == 0 && j >= 0) : (i == 0 && j == 0);
      const bool valid = i <= n && j >= 0 && j <= m;
      v = origin ? 0 : v;
      v = valid ? v : kInf;
      v = min(v, kInf);
      const uint32_t b = (valid && !origin && v < kInf) ? mv : 3u;
      words[k / 4] |= b << (8 * (k % 4));
      if (MODE == kGlobal) {
        if (valid && i == n && j == m) final_v = v;
      } else if (valid && i == n && v < best) {
        best = v;   // first antidiagonal with the strictly smallest V
        best_j = j;
      }
      Vn[k] = v;
    }
    store_moves<C>(bp_lane + (size_t)d * bp_stride, words);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      V2[k] = V1[k];
      V1[k] = Vn[k];
    }
    lo2 = lo1;
    lo1 = lo;
  }

  if (MODE == kGlobal) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      final_v = min(final_v, __shfl_xor_sync(kFull, final_v, o));
    if (lane == 0) {
      dist[p] = final_v;
      end_i[p] = n;
      end_j[p] = m;
    }
  } else {
    // lexicographic (V, j) minimum; an empty lane holds (INF, -1)
    unsigned long long key =
        ((unsigned long long)(uint32_t)best << 32) | (uint32_t)best_j;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, key, o);
      key = other < key ? other : key;
    }
    if (lane == 0) {
      dist[p] = (int32_t)(key >> 32);
      end_i[p] = n;
      end_j[p] = (int32_t)(uint32_t)key;
    }
  }
}

template <int C, int MODE>
cudaError_t launch(cudaStream_t stream, const int8_t* qg, const int8_t* trg,
                   const int32_t* n, const int32_t* m, int P, int LQG,
                   int LTG, int Lt, int G, int Dmax, int32_t* dist,
                   int32_t* end_i, int32_t* end_j, int8_t* bp) {
  const size_t smem = (size_t)LQG + (size_t)LTG;
  auto* kernel = banded_dp_kernel<C, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<P, 32, smem, stream>>>(qg, trg, n, m, P, LQG, LTG, Lt, G, Dmax,
                                  dist, end_i, end_j, bp);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_width(int W, cudaStream_t stream, const int8_t* qg,
                         const int8_t* trg, const int32_t* n,
                         const int32_t* m, int P, int LQG, int LTG, int Lt,
                         int G, int Dmax, int32_t* dist, int32_t* end_i,
                         int32_t* end_j, int8_t* bp) {
#define FALCON_LAUNCH(C)                                                    \
  return launch<C, MODE>(stream, qg, trg, n, m, P, LQG, LTG, Lt, G, Dmax, \
                         dist, end_i, end_j, bp)
  switch (W) {
    case 32: FALCON_LAUNCH(1);
    case 64: FALCON_LAUNCH(2);
    case 128: FALCON_LAUNCH(4);
    case 256: FALCON_LAUNCH(8);
    case 512: FALCON_LAUNCH(16);
  }
#undef FALCON_LAUNCH
  return cudaErrorInvalidValue;
}

ffi::Error BandedDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> qg,
                        ffi::Buffer<ffi::S8> trg, ffi::Buffer<ffi::S32> n,
                        ffi::Buffer<ffi::S32> m,
                        ffi::ResultBuffer<ffi::S32> dist,
                        ffi::ResultBuffer<ffi::S32> end_i,
                        ffi::ResultBuffer<ffi::S32> end_j,
                        ffi::ResultBuffer<ffi::S8> bp, int64_t Lt, int64_t G,
                        int64_t mode) {
  const auto qd = qg.dimensions();
  const auto td = trg.dimensions();
  const auto bd = bp->dimensions();
  if (qd.size() != 2 || td.size() != 2 || bd.size() != 3)
    return ffi::Error::InvalidArgument("banded_dp: bad ranks");
  const int64_t P = qd[0], LQG = qd[1], LTG = td[1];
  const int64_t Dmax = bd[0], W = bd[2];
  if (td[0] != P || bd[1] != P || n.element_count() != (size_t)P ||
      m.element_count() != (size_t)P)
    return ffi::Error::InvalidArgument("banded_dp: pair counts differ");
  if (LQG % 16 || LTG % 16)
    return ffi::Error::InvalidArgument("banded_dp: rows not 16-aligned");
  if (mode < kGlobal || mode > kTgLocal)
    return ffi::Error::InvalidArgument("banded_dp: bad mode");
  if (P == 0 || Dmax == 0) return ffi::Error::Success();
  // every row index the band touches must lie inside the staged rows
  const int64_t lo_last = band_lo((int)(Dmax - 1), (int)W);
  if (lo_last + W > LQG || G + Lt + W > LTG ||
      G + Lt - (Dmax - 1) + lo_last < 0)
    return ffi::Error::InvalidArgument("banded_dp: band leaves the rows");
  if (LQG + LTG > 227 * 1024)
    return ffi::Error::InvalidArgument(
        "banded_dp: rows exceed one block's shared memory");
  cudaError_t err;
  switch (mode) {
    case kGlobal:
      err = launch_width<kGlobal>(
          (int)W, stream, qg.typed_data(), trg.typed_data(), n.typed_data(),
          m.typed_data(), (int)P, (int)LQG, (int)LTG, (int)Lt, (int)G,
          (int)Dmax, dist->typed_data(), end_i->typed_data(),
          end_j->typed_data(), bp->typed_data());
      break;
    case kQgLocal:
      err = launch_width<kQgLocal>(
          (int)W, stream, qg.typed_data(), trg.typed_data(), n.typed_data(),
          m.typed_data(), (int)P, (int)LQG, (int)LTG, (int)Lt, (int)G,
          (int)Dmax, dist->typed_data(), end_i->typed_data(),
          end_j->typed_data(), bp->typed_data());
      break;
    default:
      err = launch_width<kTgLocal>(
          (int)W, stream, qg.typed_data(), trg.typed_data(), n.typed_data(),
          m.typed_data(), (int)P, (int)LQG, (int)LTG, (int)Lt, (int)G,
          (int)Dmax, dist->typed_data(), end_i->typed_data(),
          end_j->typed_data(), bp->typed_data());
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("banded_dp: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BandedDp, BandedDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // qg
                                  .Arg<ffi::Buffer<ffi::S8>>()   // trg
                                  .Arg<ffi::Buffer<ffi::S32>>()  // n
                                  .Arg<ffi::Buffer<ffi::S32>>()  // m
                                  .Ret<ffi::Buffer<ffi::S32>>()  // dist
                                  .Ret<ffi::Buffer<ffi::S32>>()  // end_i
                                  .Ret<ffi::Buffer<ffi::S32>>()  // end_j
                                  .Ret<ffi::Buffer<ffi::S8>>()   // bp
                                  .Attr<int64_t>("Lt")
                                  .Attr<int64_t>("G")
                                  .Attr<int64_t>("mode"));
