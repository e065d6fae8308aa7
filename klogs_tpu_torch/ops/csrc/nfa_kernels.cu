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
// grouped_nfa_gated_kernel (the GATED instantiations of the same
// template) replaces pallas_nfa.py:_grouped_kernel_gated, the
// scalar-prefetch pallas_call of _launch_grouped's gated tail: it runs
// K1's body only where a per-(line, group) gate bit says a group can
// match, computing
//
//     out[b] = OR over g of (gate[b, g] AND acc_g(b))
//
// (match_all is ORed in by the wrapper). On the TPU the gate became
// per-(tile, group) flags and a dead grid cell skipped its scan loop.
// Here the wrapper clusters candidate lines (any gate bit) to the front
// and hands over the candidate count on the device; a block wholly past
// it writes zeros and exits (the TPU's dead tiles), a live block skips
// group g when no line of its 128 has g's bit (__syncthreads_or: the
// (tile, group) skip), and inside a live group a warp whose lines all
// lack the bit skips the steps (divergent threads simply idle). What
// bounds it is what bounds K1, paid only on live (block, group) cells:
// the dependent step chain of the lines in those cells.
//
// grouped_nfa_fused_kernel replaces pallas_nfa.py:334 _grouped_kernel_fused
// (the fused pallas_call of _launch_grouped). It computes K1's function,
// out[b] = OR over g of acc_g(b), over the same bytes, so its bounds are
// K1's. On the TPU the fusion put all G groups in one grid cell: one
// one-hot per step shared by every group and one stacked [G*S, C] mask
// product, both there to feed the matrix unit. What it computes is kept
// here, not that layout: every group advances at each step off one class
// read. K1's block walks its groups one after another, so its chain is
// G x T steps, and a launch of few lines (a wide bucket at G = 156)
// leaves most SMs idle for all of them. Here the groups run side by
// side: a block holds NL lines x GC groups, one thread per (line, group)
// pair with its own register state, the class tile of its lines is
// staged once per TT steps and read by every group's threads, and the GC
// groups' tables sit in shared memory together, so a block's chain is T
// steps. The groups are cut into chunks of GC (as many as shared memory
// holds, at most FUSED_THREADS / 32) along gridDim.y. Blocks run in no
// order, so a block ORs its lines' verdicts across its groups in shared
// memory, then into a zeroed word per line with atomicOr. Programs wider
// than 32 words run grouped_nfa_fused_wide: a warp per (line, group)
// pair, a line's groups on neighbouring warps.
//
// What bounds K1, K3 and K4 on an H100: the step is a chain of T
// dependent updates per line, each an OR of follow rows chosen by the
// set bits of v. The TPU kernels spent two dense int8 matmuls per step
// on it; a Glushkov state set holds a handful of states, so here each
// step costs one 16-byte shared-memory row load per set bit plus one
// mask row -- shared-memory latency along the chain, not bytes (a
// [B, T] int16 class array is read once per group) and not dense
// arithmetic. The design keeps the chain on chip: the state lives in
// registers (one thread per line, W = S/32 words, W one of 4, 8, 16,
// 32: a program of another width up to 32 words runs padded with dead
// states to the next of them), the follow and mask bit tables of the
// current group sit in shared memory, and class ids are staged TT steps
// at a time in a padded shared tile so the global reads are row
// segments and the per-step reads hit distinct banks. These batches
// are wide (thousands of short lines), so a thread per line fills the
// card.
//
// chunk_nfa_kernel (K2) replaces pallas_nfa.py:50 _kernel (the
// pallas_call in _launch_chunk): the same step over the single augmented
// union automaton, with the state carried in and out across chunks of a
// long line in the JAX package's [B, S] int8 layout. Its batches are
// the opposite: few lines (the CLI's long-line bucket holds 8 rows) by
// thousands of steps, so a launch lasts as long as one line's chain and
// the step's latency is all that counts. So a line gets a warp, its W
// words spread over the lanes: lane j holds word j in a register (lanes
// >= W hold 0). A step is a ballot for the nonzero words, a shuffle
// that names a set state's row, and per set bit one 4-byte
// shared-memory load per lane (word j of that follow row), ANDed with
// word j of the class's mask row. What bounds it is that chain, T x
// (ballot, shuffle, one shared load per set bit), not bytes or
// arithmetic. Against the thread-per-line kernel it replaced:
// - a warp is one line, so its loops are the line's own set bits, not
//   the union of 32 lines' (no divergence);
// - no thread scans W words: the ballot finds the nonzero ones;
// - the lanes read consecutive words of a row: no bank conflicts;
// - class ids never pass through shared memory or a barrier: each lane
//   holds one id of the next 32 steps, loaded a tile ahead and walked
//   by shuffles. The step loop has no __syncthreads.
// Two exact shortcuts take most steps off that chain. The augmented
// live state is always set, so the reach of the "sticky" states (a
// self-loop, in every nonzero mask row) is kept from step to step, and
// a step whose other states are empty needs no row load; and while v
// is only those states, the steps whose class maps v to itself are
// skipped a run at a time (one ballot per 32 steps finds them). The
// tables are read through 32-bit shared-window addresses held in
// registers: through generic pointers the compiler rebuilt the window
// base (special-register reads) on every step. A block is CHUNK_WARPS
// lines sharing one copy of the tables (follow [S][W] and mask [C][W]
// words in shared memory, 136 KB at S = 1024 and C = 64), so 1024 lines
// spread over 128 SMs.
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
constexpr int CHUNK_WARPS = 8;      // lines (a warp each) per block, chunk
constexpr int FUSED_THREADS = 256;  // threads per block, fused: lines x groups
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

// Stage cls[line0 .. line0+nl) x [t0, t0+TT) into tile[nl][TT+1] as
// int32, with the block's `nthreads` threads. A warp reads TT
// consecutive ids of one line (a 64-byte row segment); the +1 pad puts
// line l's row on bank l mod 32 for the per-step reads.
__device__ __forceinline__ void load_cls_tile(const int16_t* __restrict__ cls,
                                              int B, int T, int line0, int t0,
                                              int* tile, int nl,
                                              int nthreads) {
  for (int k = threadIdx.x; k < nl * TT; k += nthreads) {
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

// The grouped scan (K1) and, with GATED, the gated one (K3). gate is
// [B, GW] words (bit g % 32 of word g / 32 = group g may match line b),
// and n_cand points at the number of leading lines with any bit set;
// both are ignored when !GATED.
template <int W, bool GATED>
__global__ void __launch_bounds__(GROUPED_LINES)
    grouped_nfa_kernel(const int16_t* __restrict__ cls, int B, int T,
                       const uint32_t* __restrict__ follow,
                       const uint32_t* __restrict__ mask, int G, int C,
                       int live, int acc, const uint32_t* __restrict__ gate,
                       int GW, const int* __restrict__ n_cand,
                       uint8_t* __restrict__ out) {
  constexpr int S = 32 * W;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* f_s = smem;
  uint32_t* m_s = f_s + S * W;
  int* tile = reinterpret_cast<int*>(m_s + C * W);
  const int line0 = blockIdx.x * GROUPED_LINES;
  const int line = line0 + threadIdx.x;
  if (GATED && line0 >= *n_cand) {  // a dead block: no candidate line
    if (line < B) out[line] = 0;
    return;
  }
  const int* my = tile + threadIdx.x * (TT + 1);
  bool matched = false;
  uint32_t word = 0u;
  for (int g = 0; g < G; ++g) {
    bool mine = true;
    if (GATED) {
      if ((g & 31) == 0)
        word = line < B ? gate[(size_t)line * GW + (g >> 5)] : 0u;
      mine = (word >> (g & 31)) & 1u;
      if (!__syncthreads_or(mine)) continue;  // no line of the block
    }
    __syncthreads();  // the previous group's steps are done with f_s/m_s
    copy_rows<W>(f_s, follow + (size_t)g * S * W, S, GROUPED_LINES);
    copy_rows<W>(m_s, mask + (size_t)g * C * W, C, GROUPED_LINES);
    uint32_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      v[j] = (j == (live >> 5)) ? (1u << (live & 31)) : 0u;
    for (int t0 = 0; t0 < T; t0 += TT) {
      __syncthreads();  // tile readers are done (and tables are written)
      load_cls_tile(cls, B, T, line0, t0, tile, GROUPED_LINES, GROUPED_LINES);
      __syncthreads();
      const int n = min(TT, T - t0);
      if (mine)
        for (int tt = 0; tt < n; ++tt) nfa_step<W>(v, f_s, m_s, C, my[tt]);
    }
    matched = matched || (mine && test_bit<W>(v, acc));
  }
  if (line < B) out[line] = matched ? 1 : 0;
}

// Shared-memory layout of the fused kernel: follow [GC][S][W], mask
// [GC][C][W], the class tile [NL][TT+1], then one hit word per line.
template <int W>
size_t fused_smem_bytes(int C, int NL, int GC) {
  return ((size_t)GC * (32 * W + C) * W + (size_t)NL * (TT + 2)) * 4;
}

// K4: NL lines x GC groups per block, thread (l, g) = threadIdx.x
// (l + NL * g), so a warp is 32 lines of one group and reads the class
// tile as K1 does. Block (x, y) takes lines [x * NL, x * NL + NL) and
// groups [y * GC, y * GC + GC); the last chunk may hold fewer groups,
// and its surplus threads only join the barriers. `out` is zeroed by
// the caller; a block sets the word of each line one of its groups
// accepts.
template <int W>
__global__ void __launch_bounds__(FUSED_THREADS)
    grouped_nfa_fused_kernel(const int16_t* __restrict__ cls, int B, int T,
                             const uint32_t* __restrict__ follow,
                             const uint32_t* __restrict__ mask, int G, int C,
                             int live, int acc, int NL, int GC,
                             uint32_t* __restrict__ out) {
  constexpr int S = 32 * W;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* f_s = smem;
  uint32_t* m_s = f_s + (size_t)GC * S * W;
  int* tile = reinterpret_cast<int*>(m_s + (size_t)GC * C * W);
  uint32_t* hit = reinterpret_cast<uint32_t*>(tile + NL * (TT + 1));
  const int nthreads = NL * GC;
  const int g0 = blockIdx.y * GC, ng = min(GC, G - g0);
  copy_rows<W>(f_s, follow + (size_t)g0 * S * W, ng * S, nthreads);
  copy_rows<W>(m_s, mask + (size_t)g0 * C * W, ng * C, nthreads);
  if (threadIdx.x < NL) hit[threadIdx.x] = 0u;
  const int l = threadIdx.x % NL, g = threadIdx.x / NL;
  const int line0 = blockIdx.x * NL;
  const bool mine = g < ng;  // warp-uniform: NL is a multiple of 32
  const uint32_t* f_g = f_s + (size_t)g * S * W;
  const uint32_t* m_g = m_s + (size_t)g * C * W;
  const int* my = tile + l * (TT + 1);
  uint32_t v[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    v[j] = (j == (live >> 5)) ? (1u << (live & 31)) : 0u;
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();  // tile readers are done (and tables are written)
    load_cls_tile(cls, B, T, line0, t0, tile, NL, nthreads);
    __syncthreads();
    const int n = min(TT, T - t0);
    if (mine)
      for (int tt = 0; tt < n; ++tt) nfa_step<W>(v, f_g, m_g, C, my[tt]);
  }
  __syncthreads();  // hit is zeroed even when the loop ran no barrier
  if (mine && test_bit<W>(v, acc)) atomicOr(&hit[l], 1u);
  __syncthreads();
  const int line = line0 + threadIdx.x;
  if (threadIdx.x < NL && line < B && hit[threadIdx.x])
    atomicOr(out + line, 1u);
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

// State word w of a line's [S] int8 carry: its 32 bytes at p = row +
// 32 w, two 16-byte loads, a bit per nonzero byte.
__device__ __forceinline__ uint32_t carry_word(const int8_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = q[0], b = q[1];
  return nz4(a.x) | nz4(a.y) << 4 | nz4(a.z) << 8 | nz4(a.w) << 12 |
         nz4(b.x) << 16 | nz4(b.y) << 20 | nz4(b.z) << 24 | nz4(b.w) << 28;
}

// The inverse: state word x as 32 0/1 bytes at p.
__device__ __forceinline__ void store_carry_word(int8_t* p, uint32_t x) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(spread4(x), spread4(x >> 4), spread4(x >> 8),
                    spread4(x >> 12));
  q[1] = make_uint4(spread4(x >> 16), spread4(x >> 20), spread4(x >> 24),
                    spread4(x >> 28));
}

constexpr unsigned FULL = 0xffffffffu;

// K2 reads its tables through 32-bit shared-window addresses: a generic
// pointer into shared memory makes the compiler rebuild the window base
// (S2R SR_CgaCtaId and address arithmetic) on the step's path.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The value of x, opaque to the compiler: a base address so passed is
// kept in a register rather than rebuilt from threadIdx and the window
// base (both special-register reads) at each use.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// volatile keeps the load below the barrier that publishes the tables.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(x) : "r"(addr));
  return x;
}

// K2's mask word for a lane: word `lane` of mask row c (m_lane is the
// address of the lane's word of row 0), 0 past W and for a class id
// outside [0, C), which kills every state, as the one-hot product of the
// JAX kernels does.
template <int W>
__device__ __forceinline__ uint32_t mask_word(uint32_t m_lane, int C, int c,
                                              int lane) {
  const bool in = (unsigned)c < (unsigned)C;  // no branch: row 0 stands in
  const uint32_t w = lds(m_lane + (in ? c : 0) * W * 4);
  return lane < W && in ? w : 0u;
}

// A lane's word of reach(x), x being the warp's W-word state subset
// spread over the lanes (lane j: word j), and nz the ballot of its
// nonzero words. f_lane is the address of the lane's word of follow
// row 0. Most steps hold one bit, so that case is straight-line: each
// lane names the row of its highest set bit (one FLO, issued beside
// the ballot), the highest nonzero word's lane is taken, and one
// shuffle of that row number and one load follow. Whatever bits
// remain are walked after that load is issued: the owner of each
// nonzero word broadcasts it, and its rows are read four a round, the
// loads issued before any is used (a missing bit repeats the last one:
// OR is idempotent).
template <int W>
__device__ __forceinline__ uint32_t reach_word(uint32_t nz, uint32_t x,
                                               uint32_t f_lane, int lane) {
  const int hi = 31 - __clz(x);   // -1 where x == 0: never taken
  const int q = 31 - __clz(nz);  // -1 when nz == 0: row 0 stands in
  const int s = __shfl_sync(FULL, 32 * lane + hi, q & 31);
  const uint32_t r0 = lds(f_lane + (nz ? s : 0) * W * 4);
  uint32_t r = nz ? r0 : 0u;
  if (lane == q) x &= ~(1u << hi);
  nz = __ballot_sync(FULL, x != 0u);
  if (__builtin_expect(nz == 0u, 1)) return r;
  while (nz) {
    const int w = __ffs(nz) - 1;
    nz &= nz - 1u;
    uint32_t bits = __shfl_sync(FULL, x, w);
    const uint32_t rows = f_lane + w * 32 * W * 4;
    while (bits) {
      const int b0 = __ffs(bits) - 1;
      bits &= bits - 1u;
      const int b1 = bits ? __ffs(bits) - 1 : b0;
      bits &= bits - 1u;
      const int b2 = bits ? __ffs(bits) - 1 : b1;
      bits &= bits - 1u;
      const int b3 = bits ? __ffs(bits) - 1 : b2;
      bits &= bits - 1u;
      r |= lds(rows + b0 * W * 4) | lds(rows + b1 * W * 4) |
           lds(rows + b2 * W * 4) | lds(rows + b3 * W * 4);
    }
  }
  return r;
}

// The classes that map the state vs to itself when reach(vs) = rs:
// bit c % 32 of lane c / 32's word is set iff (rs & mask[c]) == vs on
// every word. A class id outside [0, C) is never one.
template <int W>
__device__ uint32_t fixed_classes(uint32_t vs, uint32_t rs, uint32_t m_lane,
                                  int C, int lane) {
  uint32_t fw = 0u;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const uint32_t w = lds(m_lane + c * W * 4);
    const bool ok = lane >= W || (rs & w) == vs;
    if (__all_sync(FULL, ok) && lane == (c >> 5)) fw |= 1u << (c & 31);
  }
  return fw;
}

// The ballot of a tile's fixed steps: lane l holds the class id of step
// t0 + l (past T: -1, never fixed). fw covers ids below 32 * 32.
__device__ __forceinline__ uint32_t fixed_steps(int id, uint32_t fw, int C) {
  const bool in = (unsigned)id < (unsigned)min(C, 32 * 32);
  const uint32_t w = __shfl_sync(FULL, fw, in ? id >> 5 : 0);
  return __ballot_sync(FULL, in && (w >> (id & 31) & 1u));
}

// K2: warp (threadIdx.x / 32) of block x is line x * CHUNK_WARPS + warp,
// lane j holding state word j of it (see the note at the top).
template <int W>
__global__ void __launch_bounds__(CHUNK_WARPS * 32)
    chunk_nfa_kernel(const int16_t* __restrict__ cls, int B, int T,
                     const uint32_t* __restrict__ follow,
                     const uint32_t* __restrict__ mask, int C, int acc,
                     const int8_t* __restrict__ v0, int8_t* __restrict__ vout,
                     uint8_t* __restrict__ matched) {
  constexpr int S = 32 * W;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* f_s = smem;
  uint32_t* m_s = f_s + S * W;
  copy_rows<W>(f_s, follow, S, CHUNK_WARPS * 32);
  copy_rows<W>(m_s, mask, C, CHUNK_WARPS * 32);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * CHUNK_WARPS + (threadIdx.x >> 5);
  if (line >= B) return;  // a pad row: the whole warp, after the copy
  uint32_t v = lane < W ? carry_word(v0 + (size_t)line * S + 32 * lane) : 0u;
  // Lanes past W read (and drop) the words of lanes lane % W: the same
  // addresses, so the reads broadcast and stay in bounds.
  const uint32_t f_lane = opaque(smem_addr(f_s + (lane & (W - 1))));
  const uint32_t m_lane = opaque(smem_addr(m_s + (lane & (W - 1))));
  // Sticky states: a self-loop, and a member of every nonzero mask row
  // (a zero row kills every state). Once set they stay set until a
  // kill: the augmented live and acc states. reach is OR-linear, so
  // reach(v) = reach(v & sticky) | reach(v & ~sticky), and the first
  // term, rs, is kept from the last step whose sticky part vs it was
  // computed for. When v is just vs, a class c with rs & mask[c] == vs
  // maps v to itself (fw: those classes), so the steps of such classes
  // are skipped, a run at a time: most steps, where v = {live}. Both
  // are keyed on the exact sticky part, so they are exact whatever this
  // set holds.
  uint32_t sticky = 0u;
  if (lane < W)
    for (int b = 0; b < 32; ++b)
      sticky |= (f_s[(32 * lane + b) * W + lane] >> b & 1u) << b;
  for (int c = 0; c < C; ++c) {
    const uint32_t w = lane < W ? m_s[c * W + lane] : 0u;
    if (__any_sync(FULL, w != 0u)) sticky &= w;
  }
  uint32_t vs = 0u, rs = 0u;  // reach of the empty set
  uint32_t fw = fixed_classes<W>(vs, rs, m_lane, C, lane);
  // cur holds the ids of steps [t0, t0 + 32) (lane l: step t0 + l), nxt
  // those of the 32 after, loaded a tile ahead; an id past T is never
  // stepped on.
  const int16_t* ids = cls + (size_t)line * T;
  int cur = lane < T ? ids[lane] : -1;
  int nxt = 32 + lane < T ? ids[32 + lane] : -1;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int n = min(32, T - t0);
    uint32_t fx = fixed_steps(cur, fw, C);
    for (int tt = 0; tt < n; ++tt) {
      const uint32_t x = v & ~sticky;
      const uint32_t nz = __ballot_sync(FULL, x != 0u);
      if (__builtin_expect(__any_sync(FULL, (v & sticky) != vs), 0)) {
        vs = v & sticky;
        rs = reach_word<W>(__ballot_sync(FULL, vs != 0u), vs, f_lane, lane);
        fw = fixed_classes<W>(vs, rs, m_lane, C, lane);
        fx = fixed_steps(cur, fw, C);
      }
      if (nz == 0u) {  // v == vs: skip the steps that keep it
        const uint32_t run = ~(fx >> tt);
        tt = run ? tt + __ffs(run) - 1 : 32;
        if (tt >= n) break;
      }
      const uint32_t m = mask_word<W>(m_lane, C, __shfl_sync(FULL, cur, tt),
                                      lane);
      v = (rs | reach_word<W>(nz, x, f_lane, lane)) & m;
    }
    cur = nxt;
    nxt = t0 + 64 + lane < T ? ids[t0 + 64 + lane] : -1;
  }
  if (lane < W) store_carry_word(vout + (size_t)line * S + 32 * lane, v);
  if (lane == (acc >> 5)) matched[line] = (v >> (acc & 31)) & 1u;
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

template <bool GATED>
__global__ void grouped_nfa_wide(const int16_t* __restrict__ cls, int B,
                                 int T, const uint32_t* __restrict__ follow,
                                 const uint32_t* __restrict__ mask, int G,
                                 int S, int C, int live, int acc,
                                 const uint32_t* __restrict__ gate, int GW,
                                 const int* __restrict__ n_cand,
                                 uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = S / 32, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* v = smem + (size_t)warp * 2 * W;
  uint32_t* r = v + W;
  const int line = blockIdx.x * (blockDim.x >> 5) + warp;
  bool matched = false;
  // A line past the candidates has no gate bit: it scans nothing. The
  // gate is per line here (a warp is a line), so each group is skipped
  // or scanned by the whole warp.
  const bool scan = !GATED || line < *n_cand;
  for (int g = 0; scan && g < G; ++g) {
    if (GATED && !((gate[(size_t)line * GW + (g >> 5)] >> (g & 31)) & 1u))
      continue;
    for (int k = lane; k < W; k += 32)
      v[k] = k == (live >> 5) ? 1u << (live & 31) : 0u;
    wide_scan(v, r, W, lane, cls, B, T, line, follow + (size_t)g * S * W,
              mask + (size_t)g * C * W, C);
    matched = matched || wide_bit(v, acc);
    __syncwarp();  // every lane has read v before the next group resets it
  }
  if (line < B && lane == 0) out[line] = matched ? 1 : 0;
}

// K4 past 32 words: one warp per (line, group) pair, pair p = line * G +
// g, so a line's groups run side by side on neighbouring warps (and read
// its class ids through the same L1 lines). `out` as for the fused
// kernel: zeroed by the caller, a word set per accepted line.
__global__ void grouped_nfa_fused_wide(const int16_t* __restrict__ cls,
                                       int B, int T,
                                       const uint32_t* __restrict__ follow,
                                       const uint32_t* __restrict__ mask,
                                       int G, int S, int C, int live, int acc,
                                       uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = S / 32, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* v = smem + (size_t)warp * 2 * W;
  uint32_t* r = v + W;
  const long long pair = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const int line = (int)(pair / G), g = (int)(pair % G);
  if (line >= B) return;  // the whole warp: a warp is one pair
  for (int k = lane; k < W; k += 32)
    v[k] = k == (live >> 5) ? 1u << (live & 31) : 0u;
  wide_scan(v, r, W, lane, cls, B, T, line, follow + (size_t)g * S * W,
            mask + (size_t)g * C * W, C);
  if (wide_bit(v, acc) && lane == 0) atomicOr(out + line, 1u);
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
  for (int k = lane; k < W; k += 32)
    v[k] = line < B ? carry_word(v0 + (size_t)line * S + 32 * k) : 0u;
  wide_scan(v, r, W, lane, cls, B, T, line, follow, mask, C);
  if (line < B) {
    for (int k = lane; k < W; k += 32)
      store_carry_word(vout + (size_t)line * S + 32 * k, v[k]);
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

template <int W, bool GATED>
cudaError_t launch_grouped(const int16_t* cls, int B, int T,
                           const uint32_t* follow, const uint32_t* mask, int G,
                           int C, int live, int acc, const uint32_t* gate,
                           int GW, const int* n_cand, uint8_t* out,
                           cudaStream_t stream) {
  const size_t smem = reg_smem_words<W, GROUPED_LINES>(C) * 4;
  cudaError_t e = allow_smem(grouped_nfa_kernel<W, GATED>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + GROUPED_LINES - 1) / GROUPED_LINES;
  grouped_nfa_kernel<W, GATED><<<blocks, GROUPED_LINES, smem, stream>>>(
      cls, B, T, follow, mask, G, C, live, acc, gate, GW, n_cand, out);
  return cudaGetLastError();
}

// K1 (GATED false: gate and n_cand unused) or K3 over any S.
template <bool GATED>
cudaError_t launch_grouped_any(const int16_t* cls, int B, int T,
                               const uint32_t* follow, const uint32_t* mask,
                               int G, int S, int C, int live, int acc,
                               const uint32_t* gate, int GW, const int* n_cand,
                               uint8_t* out, cudaStream_t st) {
  switch (S / 32) {
    case 4: return launch_grouped<4, GATED>(cls, B, T, follow, mask, G, C, live, acc, gate, GW, n_cand, out, st);
    case 8: return launch_grouped<8, GATED>(cls, B, T, follow, mask, G, C, live, acc, gate, GW, n_cand, out, st);
    case 16: return launch_grouped<16, GATED>(cls, B, T, follow, mask, G, C, live, acc, gate, GW, n_cand, out, st);
    case 32: return launch_grouped<32, GATED>(cls, B, T, follow, mask, G, C, live, acc, gate, GW, n_cand, out, st);
    default: break;
  }
  const int nw = S > 32 * 32 ? wide_warps(S) : 0;
  if (nw == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (S / 32) * nw * 4;
  cudaError_t e = allow_smem(grouped_nfa_wide<GATED>, smem);
  if (e != cudaSuccess) return e;
  grouped_nfa_wide<GATED><<<(B + nw - 1) / nw, 32 * nw, smem, st>>>(
      cls, B, T, follow, mask, G, S, C, live, acc, gate, GW, n_cand, out);
  return cudaGetLastError();
}

// Lines per fused block for GC groups: the rest of FUSED_THREADS, in
// whole warps.
int fused_lines(int gc) {
  const int nl = FUSED_THREADS / gc / 32 * 32;
  return nl > 32 ? nl : 32;
}

template <int W>
cudaError_t launch_fused(const int16_t* cls, int B, int T,
                         const uint32_t* follow, const uint32_t* mask, int G,
                         int C, int live, int acc, uint32_t* out,
                         cudaStream_t stream) {
  // The most groups a block's shared memory holds, at most a warp of
  // lines each; then as few chunks as that allows, evened out.
  int gc = G < FUSED_THREADS / 32 ? G : FUSED_THREADS / 32;
  while (gc > 0 &&
         fused_smem_bytes<W>(C, fused_lines(gc), gc) > (size_t)MAX_SMEM)
    --gc;
  if (gc == 0) return cudaErrorInvalidValue;
  const int chunks = (G + gc - 1) / gc;
  const int even = (G + chunks - 1) / chunks;
  if (fused_smem_bytes<W>(C, fused_lines(even), even) <= (size_t)MAX_SMEM)
    gc = even;
  const int nl = fused_lines(gc);
  const size_t smem = fused_smem_bytes<W>(C, nl, gc);
  cudaError_t e = allow_smem(grouped_nfa_fused_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + nl - 1) / nl, (G + gc - 1) / gc);
  grouped_nfa_fused_kernel<W><<<grid, nl * gc, smem, stream>>>(
      cls, B, T, follow, mask, G, C, live, acc, nl, gc, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_chunk(const int16_t* cls, int B, int T,
                         const uint32_t* follow, const uint32_t* mask, int C,
                         int acc, const int8_t* v0, int8_t* vout,
                         uint8_t* matched, cudaStream_t stream) {
  const size_t smem = ((size_t)32 * W + C) * W * 4;  // follow, mask
  cudaError_t e = allow_smem(chunk_nfa_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + CHUNK_WARPS - 1) / CHUNK_WARPS;
  chunk_nfa_kernel<W><<<blocks, CHUNK_WARPS * 32, smem, stream>>>(
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
  return launch_grouped_any<false>(cls, B, T, follow, mask, G, S, C, live,
                                   acc, nullptr, 0, nullptr, out,
                                   static_cast<cudaStream_t>(stream));
}

// As klogs_grouped_nfa, gated: gate [B, GW] uint32 words (lines with any
// bit set first), n_cand a device int holding how many lines have one.
int klogs_grouped_nfa_gated(const int16_t* cls, int B, int T,
                            const uint32_t* follow, const uint32_t* mask,
                            int G, int S, int C, int live, int acc,
                            const uint32_t* gate, int GW, const int* n_cand,
                            uint8_t* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  return launch_grouped_any<true>(cls, B, T, follow, mask, G, S, C, live,
                                  acc, gate, GW, n_cand, out,
                                  static_cast<cudaStream_t>(stream));
}

// K4: as klogs_grouped_nfa, with out [B] uint32 words that the caller
// zeroed (a word is set to 1 for each matching line).
int klogs_grouped_nfa_fused(const int16_t* cls, int B, int T,
                            const uint32_t* follow, const uint32_t* mask,
                            int G, int S, int C, int live, int acc,
                            uint32_t* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (G <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / 32) {
    case 4: return launch_fused<4>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 8: return launch_fused<8>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 16: return launch_fused<16>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 32: return launch_fused<32>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    default: break;
  }
  const int nw = S > 32 * 32 ? wide_warps(S) : 0;
  if (nw == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (S / 32) * nw * 4;
  e = allow_smem(grouped_nfa_fused_wide, smem);
  if (e != cudaSuccess) return e;
  const long long pairs = (long long)B * G;
  grouped_nfa_fused_wide<<<(unsigned)((pairs + nw - 1) / nw), 32 * nw, smem,
                           st>>>(cls, B, T, follow, mask, G, S, C, live, acc,
                                 out);
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
