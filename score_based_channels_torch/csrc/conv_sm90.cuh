// Pieces shared by the bf16 wgmma conv kernels (conv2d_taps.cu,
// conv_im2col.cu): the tap table, the output tiles of a persistent block,
// the warpgroup epilogue and the size of the persistent grid.
//
// Both kernels keep a block resident on an SM for several output tiles: it
// loads the weights of its BN output channels once, and its producer warp
// loads the next tile's activations while the consumer warpgroups multiply
// and store the current one. A tile is SB samples x TH whole rows x W
// columns (P = SB * TH * W <= 64 per consumer warpgroup); tiles are
// numbered with the row tile fastest.

#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "sm90.cuh"

namespace conv_sm90 {

using bf16 = __nv_bfloat16;
constexpr int kMaxTaps = 9;
constexpr int kMaxWG = 2;  // consumer warpgroups per block

struct TapTable {
  int n;
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  int wi[kMaxTaps];  // tap index iy*k + ix into the weight
};

// the table of n live taps (offsets dy, dx; weight index wi), from the
// host's arrays; false if n is not 1..kMaxTaps
inline bool make_taps(TapTable* t, int n, const int* dy, const int* dx,
                      const int* wi) {
  if (n < 1 || n > kMaxTaps) return false;
  t->n = n;
  for (int i = 0; i < kMaxTaps; ++i) {
    t->dy[i] = i < n ? dy[i] : 0;
    t->dx[i] = i < n ? dx[i] : 0;
    t->wi[i] = i < n ? wi[i] : 0;
  }
  return true;
}

struct Tile {
  int b0, h0;
  __device__ __forceinline__ Tile(int mt, int H, int TH, int SB) {
    const int nrt = (H + TH - 1) / TH;
    b0 = (mt / nrt) * SB;
    h0 = (mt % nrt) * TH;
  }
};

// a barrier among the 128 threads of consumer warpgroup wg (ids 1, 2: the
// id is a constant, so a block holds only the barriers it uses)
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Epilogue of consumer warpgroup wg (pixels 64 wg .. 64 wg + 63 of the
// tile): + bias (f32 or bf16), ELU, one rounding to bf16 into its staging
// rows st (64 x (BN + 8)), then 16-byte stores of its pixels that lie in
// the tensor, pixel (b, h, w) at out + b os_b + h os_h + w os_w.
template <int BN>
__device__ __forceinline__ void store_tile(
    const float* acc, bf16* st, int wg, const void* bias, int bias_bf16,
    int elu, bf16* out, long long os_b, long long os_h, long long os_w,
    int n0, int Cout, const Tile& tile, int B, int H, int W, int TH, int P,
    int o_vec) {
  constexpr int SP = BN + 8;  // staging pitch: rows 16 bytes apart in banks
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3), n = n0 + col;
    float bv0 = 0.f, bv1 = 0.f;
    if (bias != nullptr) {
      if (bias_bf16) {
        const bf16* bb = static_cast<const bf16*>(bias);
        if (n < Cout) bv0 = __bfloat162float(bb[n]);
        if (n + 1 < Cout) bv1 = __bfloat162float(bb[n + 1]);
      } else {
        const float* bb = static_cast<const float*>(bias);
        if (n < Cout) bv0 = bb[n];
        if (n + 1 < Cout) bv1 = bb[n + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + bv0, v1 = acc[4 * j + 2 * h + 1] + bv1;
      if (elu) {
        v0 = v0 > 0.f ? v0 : expm1f(v0);
        v1 = v1 > 0.f ? v1 : expm1f(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8 * h) * SP + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  warpgroup_barrier(wg);
  constexpr int groups = BN / 8;
  const int tile_px = TH * W;
  for (int i = t; i < 64 * groups; i += 128) {
    const int g = i % groups, r = i / groups, pp = 64 * wg + r;
    const int n = n0 + 8 * g;
    if (pp >= P || n >= Cout) continue;
    const int rem = pp % tile_px;
    const int b = tile.b0 + pp / tile_px, h = tile.h0 + rem / W;
    if (b >= B || h >= H) continue;
    bf16* o = out + b * os_b + h * os_h + (rem % W) * os_w + n;
    const uint4 v = *reinterpret_cast<const uint4*>(st + r * SP + 8 * g);
    if (o_vec && n + 8 <= Cout) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int k = 0; k < 8 && n + k < Cout; ++k) o[k] = e[k];
    }
  }
  warpgroup_barrier(wg);  // the staging rows are free again
}

// A weight slice in shared memory: KW rows (K) x BN channels (N) from n0,
// N-major, in boxes of NB = min(BN, 64) channels (rows of 2 NB bytes,
// swizzled as TMA writes them; sm90::desc_nmajor reads them), box b at
// b * KW * 2 NB bytes.
__host__ __device__ __forceinline__ int weight_row_bytes(int BN) {
  return 2 * (BN < 64 ? BN : 64);
}

// The producer warp's slice: by TMA from the 2-D map of the (rows, Cout)
// weight memory when wmap (KW consecutive rows from row0), else by plain
// loads of row_of(k) (-1: a zero row), zero past Cout. bar completes when
// the slice is in.
template <class RowOf>
__device__ __forceinline__ void load_weight_slice(
    uint8_t* dst, const CUtensorMap* wmap, const bf16* w, int row0, int KW,
    int BN, int n0, int Cout, RowOf row_of, uint64_t* bar, int lane) {
  const int rb = weight_row_bytes(BN), nbox = BN * 2 / rb;
  if (wmap != nullptr) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(bar, KW * BN * 2);
      for (int b = 0; b < nbox; ++b)
        sm90::tma_load_2d(dst + b * KW * rb, wmap, bar, n0 + b * rb / 2,
                          row0);
    }
    return;
  }
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);
  const int groups = BN / 8, per_row = rb / 16;  // 16-byte pieces
  for (int id = lane; id < groups * KW; id += 32) {
    const int j = id % groups, k = id / groups;
    const int row = row_of(k), n = n0 + 8 * j;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row >= 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < Cout)
          v[e >> 1] |= (uint32_t)ws[(size_t)row * Cout + n + e]
                       << (16 * (e & 1));
    }
    uint8_t* d = dst + (j / per_row) * KW * rb +
                 sm90::swizzle(k * rb + (j % per_row) * 16, rb);
    *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  sm90::fence_proxy_async();  // plain stores, read by wgmma
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(bar);
}

// TMA takes the (rows, Cout) weight memory at w when its rows are 16-byte
// aligned: Cout a multiple of 8 and w 16-byte aligned. Otherwise
// load_weight_slice loads the slices element by element.
inline bool weight_takes_tma(const void* w, int Cout) {
  return Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// The weight map for load_weight_slice: the (rows, Cout) memory at w in
// boxes of (NB channels, KW rows); false if the CUDA driver refuses it.
inline bool make_weight_map(CUtensorMap* map, const void* w, int rows,
                            int Cout, int KW, int BN) {
  const int rb = weight_row_bytes(BN);
  const uint64_t dims[2] = {(uint64_t)Cout, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)Cout * 2};
  const uint32_t box[2] = {(uint32_t)rb / 2, (uint32_t)KW};
  return sm90::make_map(map, w, 2, dims, strides, box,
                        sm90::swizzle_mode(rb));
}

// The last persistent launch: its kernel, what sized its grid and the
// grid's blocks along the tile axis (sbc_conv_last_launch reads it).
struct LastLaunch {
  const void* kernel;
  int threads, smem, tiles, channel_tiles, blocks;
};
inline LastLaunch& last_launch() {
  static LastLaunch l{};
  return l;
}

// Blocks along the tile axis of a persistent launch of kernel: as many as
// the card holds at once over all channel tiles, at most one per tile. The
// card's blocks per SM are asked once per (kernel, threads, shared bytes)
// and kept: the query costs more host time than the launch.
inline int persistent_blocks(const void* kernel, int threads, int smem,
                             int tiles, int channel_tiles) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int>, int> per_sm_of;
  static int sms = 0;
  std::lock_guard<std::mutex> guard(lock);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int& per_sm = per_sm_of[std::make_tuple(kernel, threads, smem)];
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    if (per_sm < 1) per_sm = 1;
  }
  const int want = (sms * per_sm + channel_tiles - 1) / channel_tiles;
  const int blocks = want < tiles ? want : tiles;
  last_launch() = {kernel, threads, smem, tiles, channel_tiles, blocks};
  return blocks;
}

}  // namespace conv_sm90
