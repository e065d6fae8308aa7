// Batch NFA scan kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Both kernels run the augmented Glushkov step of ops/nfa.py over
// host- or device-classified class ids:
//
//     v' = reach(v) & mask[cls[t]],   reach(v) = OR of follow[s] over s in v
//
// with a line's state set v held as a bitset of S/32 words (bit b of
// word w is state 32w+b).
//
// grouped_nfa_kernel replaces klogs_tpu/ops/pallas_nfa.py:_grouped_kernel
// / _grouped_kernel_body (the ungated pallas_call in _launch_grouped):
// G automata of S states over one shared classifier, v starting at
// {live} in every group, the verdict being row `acc` ORed over groups.
// On the TPU the group axis was a sequential grid axis whose output
// block carried that OR; blocks share nothing here, so the group loop
// sits inside the block and the block ORs `acc` itself before writing
// one byte per line.
//
// chunk_nfa_kernel replaces pallas_nfa.py:_kernel (the pallas_call in
// _launch_chunk): the same step over the single augmented union
// automaton, with the state carried in and out across chunks of a long
// line in the JAX package's [B, S] int8 layout.
//
// What bounds them on an H100: the step is a chain of T dependent
// updates per line, each an OR of follow rows chosen by the set bits of
// v. The TPU kernel spent two dense int8 matmuls per step on it; a
// Glushkov state set holds a handful of states, so here each step costs
// one 16-byte shared-memory row load per set bit plus one mask row --
// shared-memory latency along the chain, not bytes (a [B, T] int16
// class array is read once per group) and not dense arithmetic. The
// design keeps the chain on chip: the state lives in registers (one
// thread per line, W = S/32 words, W one of 4, 8, 16, 32: a program of
// another width up to 32 words runs padded with dead states to the
// next of them), the follow and mask bit tables of the current group
// sit in shared memory, and class ids are staged TT steps at a time in a
// padded shared tile so the global reads are row segments and the
// per-step reads hit distinct banks.
// Parallelism is one thread per line, so a batch of few lines (long-line
// chunks) occupies few SMs; splitting a line's words across threads is
// left to a later change.
//
// Programs wider than S = 1024 (W > 32): the *_wide kernels give each
// line a warp, its state in shared memory, and read follow/mask rows
// from device memory through L2 in coalesced row passes, so every
// pattern set the compiler accepts runs.
//
// Every entry point returns the cudaError_t of its launch (0 = success)
// and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;            // class-id steps staged per shared tile
constexpr int GROUPED_LINES = 128;  // lines (threads) per block, grouped
constexpr int CHUNK_LINES = 32;     // lines per block, chunk (few lines)
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

// Stage cls[line0 .. line0+NL) x [t0, t0+TT) into tile[NL][TT+1] as int32.
// A warp reads TT consecutive ids of one line (a 64-byte row segment);
// the +1 pad puts line l's row on bank l mod 32 for the per-step reads.
template <int NL>
__device__ __forceinline__ void load_cls_tile(const int16_t* __restrict__ cls,
                                              int B, int T, int line0, int t0,
                                              int* tile) {
  for (int k = threadIdx.x; k < NL * TT; k += NL) {
    const int l = k / TT, tt = k % TT;
    const int line = line0 + l, t = t0 + tt;
    int c = -1;
    if (line < B && t < T) c = cls[(size_t)line * T + t];
    tile[l * (TT + 1) + tt] = c;
  }
}

// One step on a register-resident state of W words. `follow` is [S][W]
// and `mask` [C][W], both in shared memory; W is a multiple of 4, so a
// row is whole 16-byte vectors. A class id outside [0, C) kills every
// state, as the one-hot product of the JAX kernels does.
template <int W>
__device__ __forceinline__ void nfa_step(uint32_t (&v)[W],
                                         const uint32_t* follow,
                                         const uint32_t* mask, int C, int c) {
  uint32_t reach[W];
#pragma unroll
  for (int j = 0; j < W; ++j) reach[j] = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t bits = v[w];
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1u;
      const uint4* row =
          reinterpret_cast<const uint4*>(follow + (size_t)(w * 32 + b) * W);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 r = row[q];
        reach[4 * q] |= r.x;
        reach[4 * q + 1] |= r.y;
        reach[4 * q + 2] |= r.z;
        reach[4 * q + 3] |= r.w;
      }
    }
  }
  if ((unsigned)c < (unsigned)C) {
    const uint4* m = reinterpret_cast<const uint4*>(mask + (size_t)c * W);
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 r = m[q];
      v[4 * q] = reach[4 * q] & r.x;
      v[4 * q + 1] = reach[4 * q + 1] & r.y;
      v[4 * q + 2] = reach[4 * q + 2] & r.z;
      v[4 * q + 3] = reach[4 * q + 3] & r.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = 0u;
  }
}

// Bit `s` of a register-resident state (static indexing only, so the
// array stays in registers).
template <int W>
__device__ __forceinline__ bool test_bit(const uint32_t (&v)[W], int s) {
  uint32_t word = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j == (s >> 5)) word = v[j];
  return (word >> (s & 31)) & 1u;
}

template <int W>
__device__ __forceinline__ void copy_rows(uint32_t* dst,
                                          const uint32_t* __restrict__ src,
                                          int rows, int nthreads) {
  const int n = rows * W / 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int k = threadIdx.x; k < n; k += nthreads) d4[k] = s4[k];
}

// Shared-memory layout of the register kernels: follow [S][W], mask
// [C][W], then the class tile [NL][TT+1].
template <int W, int NL>
constexpr size_t reg_smem_words(int C) {
  return (size_t)32 * W * W + (size_t)C * W + (size_t)NL * (TT + 1);
}

template <int W>
__global__ void __launch_bounds__(GROUPED_LINES)
    grouped_nfa_kernel(const int16_t* __restrict__ cls, int B, int T,
                       const uint32_t* __restrict__ follow,
                       const uint32_t* __restrict__ mask, int G, int C,
                       int live, int acc, uint8_t* __restrict__ out) {
  constexpr int S = 32 * W;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* f_s = smem;
  uint32_t* m_s = f_s + S * W;
  int* tile = reinterpret_cast<int*>(m_s + C * W);
  const int line0 = blockIdx.x * GROUPED_LINES;
  const int* my = tile + threadIdx.x * (TT + 1);
  bool matched = false;
  for (int g = 0; g < G; ++g) {
    __syncthreads();  // the previous group's steps are done with f_s/m_s
    copy_rows<W>(f_s, follow + (size_t)g * S * W, S, GROUPED_LINES);
    copy_rows<W>(m_s, mask + (size_t)g * C * W, C, GROUPED_LINES);
    uint32_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      v[j] = (j == (live >> 5)) ? (1u << (live & 31)) : 0u;
    for (int t0 = 0; t0 < T; t0 += TT) {
      __syncthreads();  // tile readers are done (and tables are written)
      load_cls_tile<GROUPED_LINES>(cls, B, T, line0, t0, tile);
      __syncthreads();
      const int n = min(TT, T - t0);
      for (int tt = 0; tt < n; ++tt) nfa_step<W>(v, f_s, m_s, C, my[tt]);
    }
    matched = matched || test_bit<W>(v, acc);
  }
  const int line = line0 + threadIdx.x;
  if (line < B) out[line] = matched ? 1 : 0;
}

// Four int8 lanes of a 32-bit word -> a 4-bit "nonzero" nibble.
__device__ __forceinline__ uint32_t nz4(uint32_t x) {
  return ((x & 0xffu) != 0u) | (((x >> 8) & 0xffu) != 0u) << 1 |
         (((x >> 16) & 0xffu) != 0u) << 2 | (((x >> 24) & 0xffu) != 0u) << 3;
}

// Bits 4k..4k+3 of `bits` -> four 0/1 int8 lanes of a 32-bit word.
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return (bits & 1u) | ((bits >> 1) & 1u) << 8 | ((bits >> 2) & 1u) << 16 |
         ((bits >> 3) & 1u) << 24;
}

template <int W>
__global__ void __launch_bounds__(CHUNK_LINES)
    chunk_nfa_kernel(const int16_t* __restrict__ cls, int B, int T,
                     const uint32_t* __restrict__ follow,
                     const uint32_t* __restrict__ mask, int C, int acc,
                     const int8_t* __restrict__ v0, int8_t* __restrict__ vout,
                     uint8_t* __restrict__ matched) {
  constexpr int S = 32 * W;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* f_s = smem;
  uint32_t* m_s = f_s + S * W;
  int* tile = reinterpret_cast<int*>(m_s + C * W);
  const int line0 = blockIdx.x * CHUNK_LINES;
  const int line = line0 + threadIdx.x;
  copy_rows<W>(f_s, follow, S, CHUNK_LINES);
  copy_rows<W>(m_s, mask, C, CHUNK_LINES);
  // Carry in: the line's S int8 lanes, 32 bytes (two 16-byte loads) per
  // state word.
  uint32_t v[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    v[j] = 0u;
    if (line < B) {
      const uint4* p =
          reinterpret_cast<const uint4*>(v0 + (size_t)line * S + 32 * j);
      const uint4 a = p[0], b = p[1];
      v[j] = nz4(a.x) | nz4(a.y) << 4 | nz4(a.z) << 8 | nz4(a.w) << 12 |
             nz4(b.x) << 16 | nz4(b.y) << 20 | nz4(b.z) << 24 |
             nz4(b.w) << 28;
    }
  }
  const int* my = tile + threadIdx.x * (TT + 1);
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();
    load_cls_tile<CHUNK_LINES>(cls, B, T, line0, t0, tile);
    __syncthreads();
    const int n = min(TT, T - t0);
    for (int tt = 0; tt < n; ++tt) nfa_step<W>(v, f_s, m_s, C, my[tt]);
  }
  if (line < B) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint4* p = reinterpret_cast<uint4*>(vout + (size_t)line * S + 32 * j);
      const uint32_t x = v[j];
      p[0] = make_uint4(spread4(x), spread4(x >> 4), spread4(x >> 8),
                        spread4(x >> 12));
      p[1] = make_uint4(spread4(x >> 16), spread4(x >> 20), spread4(x >> 24),
                        spread4(x >> 28));
    }
    matched[line] = test_bit<W>(v, acc) ? 1 : 0;
  }
}

// ---- programs wider than 32 words ------------------------------------
// One warp per line. The line's state (v) and reach (r) are W-word
// buffers in shared memory, and lane l owns words l, l+32, ...: a
// ballot over the owned words finds the nonzero ones, the owner
// broadcasts each with a shuffle, and for every set bit the warp ORs
// that follow row in one coalesced pass (lane l loads words l, l+32,
// ... of the row). Tables stay in device memory, read through L2. Each
// lane touches only its own words, so the warp needs no barrier inside
// a step.

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void wide_step(uint32_t* v, uint32_t* r, int W,
                                          int lane,
                                          const uint32_t* __restrict__ follow,
                                          const uint32_t* __restrict__ mask,
                                          int C, int c) {
  for (int k = lane; k < W; k += 32) r[k] = 0u;
  for (int base = 0; base < W; base += 32) {
    const uint32_t word = base + lane < W ? v[base + lane] : 0u;
    uint32_t nz = __ballot_sync(FULL, word != 0u);
    while (nz) {
      const int q = __ffs(nz) - 1;
      nz &= nz - 1u;
      uint32_t bits = __shfl_sync(FULL, word, q);
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const uint32_t* row = follow + (size_t)((base + q) * 32 + b) * W;
        for (int k = lane; k < W; k += 32) r[k] |= __ldg(row + k);
      }
    }
  }
  if ((unsigned)c < (unsigned)C) {
    const uint32_t* m = mask + (size_t)c * W;
    for (int k = lane; k < W; k += 32) v[k] = r[k] & __ldg(m + k);
  } else {
    for (int k = lane; k < W; k += 32) v[k] = 0u;
  }
}

// The steps of one line over cls[line, 0:T): each lane loads one of the
// next 32 class ids, and the warp walks them by shuffles.
__device__ __forceinline__ void wide_scan(uint32_t* v, uint32_t* r, int W,
                                          int lane,
                                          const int16_t* __restrict__ cls,
                                          int B, int T, int line,
                                          const uint32_t* __restrict__ follow,
                                          const uint32_t* __restrict__ mask,
                                          int C) {
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int mine = (line < B && t0 + lane < T)
                         ? cls[(size_t)line * T + t0 + lane] : -1;
    const int n = min(32, T - t0);
    for (int tt = 0; tt < n; ++tt)
      wide_step(v, r, W, lane, follow, mask, C, __shfl_sync(FULL, mine, tt));
  }
}

__device__ __forceinline__ bool wide_bit(const uint32_t* v, int s) {
  __syncwarp();  // word s/32 belongs to another lane
  return (v[s >> 5] >> (s & 31)) & 1u;
}

__global__ void grouped_nfa_wide(const int16_t* __restrict__ cls, int B,
                                 int T, const uint32_t* __restrict__ follow,
                                 const uint32_t* __restrict__ mask, int G,
                                 int S, int C, int live, int acc,
                                 uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = S / 32, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* v = smem + (size_t)warp * 2 * W;
  uint32_t* r = v + W;
  const int line = blockIdx.x * (blockDim.x >> 5) + warp;
  bool matched = false;
  for (int g = 0; g < G; ++g) {
    for (int k = lane; k < W; k += 32)
      v[k] = k == (live >> 5) ? 1u << (live & 31) : 0u;
    wide_scan(v, r, W, lane, cls, B, T, line, follow + (size_t)g * S * W,
              mask + (size_t)g * C * W, C);
    matched = matched || wide_bit(v, acc);
    __syncwarp();  // every lane has read v before the next group resets it
  }
  if (line < B && lane == 0) out[line] = matched ? 1 : 0;
}

__global__ void chunk_nfa_wide(const int16_t* __restrict__ cls, int B, int T,
                               const uint32_t* __restrict__ follow,
                               const uint32_t* __restrict__ mask, int S,
                               int C, int acc,
                               const int8_t* __restrict__ v0,
                               int8_t* __restrict__ vout,
                               uint8_t* __restrict__ matched) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = S / 32, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* v = smem + (size_t)warp * 2 * W;
  uint32_t* r = v + W;
  const int line = blockIdx.x * (blockDim.x >> 5) + warp;
  for (int k = lane; k < W; k += 32) {
    uint32_t word = 0u;
    if (line < B) {
      const uint4* p =
          reinterpret_cast<const uint4*>(v0 + (size_t)line * S + 32 * k);
      const uint4 a = p[0], b = p[1];
      word = nz4(a.x) | nz4(a.y) << 4 | nz4(a.z) << 8 | nz4(a.w) << 12 |
             nz4(b.x) << 16 | nz4(b.y) << 20 | nz4(b.z) << 24 | nz4(b.w) << 28;
    }
    v[k] = word;
  }
  wide_scan(v, r, W, lane, cls, B, T, line, follow, mask, C);
  if (line < B) {
    for (int k = lane; k < W; k += 32) {
      uint4* p = reinterpret_cast<uint4*>(vout + (size_t)line * S + 32 * k);
      const uint32_t x = v[k];
      p[0] = make_uint4(spread4(x), spread4(x >> 4), spread4(x >> 8),
                        spread4(x >> 12));
      p[1] = make_uint4(spread4(x >> 16), spread4(x >> 20), spread4(x >> 24),
                        spread4(x >> 28));
    }
    const bool m = wide_bit(v, acc);
    if (lane == 0) matched[line] = m ? 1 : 0;
  }
}

// Warps (lines) per block for the wide kernels: up to 4, as many as fit
// two W-word buffers each in shared memory (0 = not even one fits).
int wide_warps(int S) {
  const size_t per_warp = (size_t)2 * (S / 32) * 4;
  int nw = 4;
  while (nw > 0 && per_warp * nw > (size_t)MAX_SMEM) nw /= 2;
  return nw;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int W>
cudaError_t launch_grouped(const int16_t* cls, int B, int T,
                           const uint32_t* follow, const uint32_t* mask, int G,
                           int C, int live, int acc, uint8_t* out,
                           cudaStream_t stream) {
  const size_t smem = reg_smem_words<W, GROUPED_LINES>(C) * 4;
  cudaError_t e = allow_smem(grouped_nfa_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + GROUPED_LINES - 1) / GROUPED_LINES;
  grouped_nfa_kernel<W><<<blocks, GROUPED_LINES, smem, stream>>>(
      cls, B, T, follow, mask, G, C, live, acc, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_chunk(const int16_t* cls, int B, int T,
                         const uint32_t* follow, const uint32_t* mask, int C,
                         int acc, const int8_t* v0, int8_t* vout,
                         uint8_t* matched, cudaStream_t stream) {
  const size_t smem = reg_smem_words<W, CHUNK_LINES>(C) * 4;
  cudaError_t e = allow_smem(chunk_nfa_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + CHUNK_LINES - 1) / CHUNK_LINES;
  chunk_nfa_kernel<W><<<blocks, CHUNK_LINES, smem, stream>>>(
      cls, B, T, follow, mask, C, acc, v0, vout, matched);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* klogs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cls [B, T] int16 (row-major), follow [G, S, S/32] and mask [G, C, S/32]
// bit tables, out [B] uint8. S/32 is a register width (4, 8, 16 or 32)
// or above 32 (the wide kernel); the caller pads a program of another
// width up to the next register width with dead states.
int klogs_grouped_nfa(const int16_t* cls, int B, int T,
                      const uint32_t* follow, const uint32_t* mask, int G,
                      int S, int C, int live, int acc, uint8_t* out,
                      void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / 32) {
    case 4: return launch_grouped<4>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 8: return launch_grouped<8>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 16: return launch_grouped<16>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 32: return launch_grouped<32>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    default: break;
  }
  const int nw = S > 32 * 32 ? wide_warps(S) : 0;
  if (nw == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (S / 32) * nw * 4;
  e = allow_smem(grouped_nfa_wide, smem);
  if (e != cudaSuccess) return e;
  grouped_nfa_wide<<<(B + nw - 1) / nw, 32 * nw, smem, st>>>(
      cls, B, T, follow, mask, G, S, C, live, acc, out);
  return cudaGetLastError();
}

// cls [B, T] int16, follow [S, S/32] and mask [C, S/32] bit tables, v0
// and vout [B, S] int8 (0/1), matched [B] uint8. S as for
// klogs_grouped_nfa.
int klogs_chunk_nfa(const int16_t* cls, int B, int T, const uint32_t* follow,
                    const uint32_t* mask, int S, int C, int acc,
                    const int8_t* v0, int8_t* vout, uint8_t* matched,
                    void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / 32) {
    case 4: return launch_chunk<4>(cls, B, T, follow, mask, C, acc, v0, vout, matched, st);
    case 8: return launch_chunk<8>(cls, B, T, follow, mask, C, acc, v0, vout, matched, st);
    case 16: return launch_chunk<16>(cls, B, T, follow, mask, C, acc, v0, vout, matched, st);
    case 32: return launch_chunk<32>(cls, B, T, follow, mask, C, acc, v0, vout, matched, st);
    default: break;
  }
  const int nw = S > 32 * 32 ? wide_warps(S) : 0;
  if (nw == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (S / 32) * nw * 4;
  e = allow_smem(chunk_nfa_wide, smem);
  if (e != cudaSuccess) return e;
  chunk_nfa_wide<<<(B + nw - 1) / nw, 32 * nw, smem, st>>>(
      cls, B, T, follow, mask, S, C, acc, v0, vout, matched);
  return cudaGetLastError();
}

}  // extern "C"
