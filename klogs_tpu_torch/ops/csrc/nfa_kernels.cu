// Batch NFA scan kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// The kernels run the augmented Glushkov step of ops/nfa.py over
// device-classified class ids:
//
//     v' = reach(v) & mask[cls[t]],   reach(v) = OR of follow[s] over s in v
//
// with a line's state set v held as a bitset of S/32 words (bit b of
// word w is state 32w+b).
//
// K1 and K4 compute one function over the same bytes, G automata of S
// states over one shared classifier, v starting at {live} in every
// group, the verdict being row `acc` ORed over groups:
//
//     out[b] = OR over g of acc_g(b)
//
// K1 (grouped_shift_kernel<W, true>) replaces
// klogs_tpu/ops/pallas_nfa.py:200 _grouped_kernel (the ungated
// pallas_call of _launch_grouped), whose group axis was a sequential
// grid axis whose output block carried that OR. K4
// (grouped_shift_kernel<W, false>) replaces pallas_nfa.py:334
// _grouped_kernel_fused (the fused pallas_call), which put all G groups
// in one grid cell, one one-hot per step feeding one stacked [G*S, C]
// mask product: a TPU layout for the matrix unit. Both are one thread
// per (line, group) pair here, the pairs of a block being NL lines x GC
// groups (a warp is 32 lines of one group) whose tables sit in shared
// memory together. They differ in what happens when G > GC: K1's block
// walks the chunks of GC groups in turn (its chain: ceil(G / GC) x T
// steps) and writes one byte per line; K4 puts the chunks on grid y and
// ORs into a zeroed word per line with atomicOr. Blocks are a warp of
// lines per group, more only where every SM still gets BLOCKS_PER_SM
// blocks.
//
// What bounds them on an H100. The step v' = reach(v) & mask[c] is a
// chain of T dependent updates per pair; a Glushkov state set holds a
// handful of states, so the bytes (a [B, T] int16 class array) and the
// nonzero terms are tiny, and a launch lasts as long as the instructions
// of its steps take to dispatch (many pairs an SM) or the latency of one
// chain (few). The step the port ran before walked every set bit of v,
// the always-set `live` included, each a dependent 16-byte shared load
// of a follow row, and its warp ran the union of 32 lines' loops. Here
// the Glushkov numbering does that work in registers: a position is
// mostly followed by the next one, so
//
//     reach(v) = shl1(v & SH) | (v & SELF) | (live in v ? RL : 0)
//                | OR of follow[s] over s in v & EX
//
// exactly, with four [W]-word constants per group built by the wrapper
// from the padded follow table: SH (s+1 follows s), SELF (s follows s),
// RL (the row of live) and EX (the "exception" states, whose rows hold
// any other edge; live excluded). shl1 is a one-bit funnel shift across
// the W words. The step is then a few register operations a word; a
// follow row is read only for a set exception bit (4-6% of pair-steps
// on FakeCluster lines at the 32 bench patterns, 0.1-0.2% at 1024).
// live's bit is picked by a select tree and smeared to a word mask. The
// mask row m depends only on the class id, so step t+1's row is loaded
// during step t: no load is on the chain. A thread loads its line's
// class ids into registers ID_AHEAD steps ahead (the GC threads of a
// line share its L1 lines), each turned into the word offset of its
// mask row (an id outside [0, C) reads a zero row, which kills every
// state, as the one-hot product of the JAX kernels does), so the step
// loop has neither a device-memory read on its chain nor a barrier. (A double-buffered shared tile of ids, one
// barrier a tile, ran 1.4x slower on a 131072 x 131 batch: PERF.md.)
// The constants live in registers up to W = 8 (the main path's groups
// are 128 states, W = 4) and are read as warp broadcasts from shared
// memory past that.
//
// grouped_nfa_gated_kernel (K3) replaces
// pallas_nfa.py:377 _grouped_kernel_gated, the scalar-prefetch
// pallas_call of _launch_grouped's gated tail: it scans a group only
// where a per-(line, group) gate bit says it can match, computing
//
//     out[b] = OR over g of (gate[b, g] AND acc_g(b))
//
// (match_all is ORed in by the wrapper). On the TPU the gate became
// per-(tile, group) flags over lines clustered candidates first, and a
// dead grid cell skipped its scan loop, so a live tile still ran every
// line of it. Here the unit of work is the candidate (line, group) pair
// itself. Three small kernels, launched by one call (gate_pairs_count,
// gate_pairs_scan of its counts, gate_pairs_scatter), compact the
// gate's set bits into a list of pairs g * B + line on the device,
// group-major and lines ascending, and leave its length there; K3 is
// then K1's thread (the shift-and-exceptions step, class ids ID_AHEAD
// steps ahead in registers, no barrier) on one listed pair, in a
// persistent grid that strides over the list, and ORs an accepted
// line's verdict byte in place with atomicOr, so neither the class ids
// nor the verdicts are permuted. A launch then costs the listed pairs'
// T steps, whatever lines they share a block with: the rate their
// steps' instructions dispatch at when they fill the card, one pair's
// chain of T steps when they do not (the bytes, a class row per pair
// and the list, are small). Consecutive threads take consecutive pairs,
// so a warp is mostly 32 lines of one group, and the group's tables,
// read through L1 rather than staged (a block's pairs may span many
// groups), are shared by the warp: its constants are one broadcast load
// per pair, its mask rows a handful of cache lines.
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
// grouped_chunk_kernel (K2g) also replaces pallas_nfa.py:50 _kernel, in
// what it computes for a line: one chunk of long lines, the state
// carried in and out, the verdict (on the final chunk) acc ORed over
// the automata. It runs them over a compile_grouped program instead of
// the augmented union, for sets whose union is wider than K2 holds in
// registers (S > 1024; 18,878 states at 1024 patterns, where K2's wide
// variant ORs a follow row of hundreds of words, read through L2 from a
// table the size of the L2, per set state per step). The union is a
// disjoint union of the patterns' automata and the groups partition the
// patterns, so the union holds acc exactly when some group does. The
// carry is a [B][G][W] word array, a (line, group) state each. Its
// batches are few lines by thousands of steps, so what bounds it is the
// latency of one chain of T steps, not bytes or arithmetic; the unit is
// K1's, a thread per (line, group) on the shift-and-exceptions step
// (scan_steps, from the carried state), so a step is a few register
// operations and B x G chains (1,248 at 8 lines and 156 groups) run
// side by side. A block is 32 groups of one line: its threads read the
// same class ids (one L1 line) ID_AHEAD steps ahead, and the group
// tables through L1, as K3 does, with no barrier anywhere.
//
// Programs wider than S = 1024 (W > 32), K1, K2g, K3 and K4: a group of
// more than 1024 states (one pattern of ~1000 positions is enough, and
// compile_grouped gives every group the widest group's S) steps by the
// same split, spread over a warp: grouped_shift_wide_kernel<K> (K1),
// grouped_chunk_wide_kernel<K> (K2g, the carry read and written as
// [B][G][W] words), grouped_fused_wide_kernel<K> (K4) and
// grouped_gated_wide_kernel<K> (K3) give a (line, group) pair a warp,
// lane l owning words l, l+32, ... (K = ceil(W/32) a lane, K <= 5: up
// to 160 words, 5120 states, past the compiler's default cap of 4096
// positions a set). The step reads no follow row but for a set
// exception bit: shl1's carry into word j, bit 31 of word j-1, crosses
// lanes as one rotating shuffle of the lane's K top bits (lane 0 takes
// lane 31's from the slot before); live's bit is found by a vote; v & EX
// is balloted, and each set bit's follow row is ORed by the whole warp
// in one coalesced pass through L1. Every number the step needs of its
// lane is computed once before the scan. Class ids are loaded 32 steps
// at a time, a lane each, and broadcast by shuffles; the class's mask
// row is read one step ahead.
// - K1, K2g and K4 share one schedule (one non-inlined body a width,
//   wide_shift_pairs): a block is WIDE_WARPS lines of one group (grid y:
//   the groups side by side, not one after another: a launch lasts its
//   longest chain), striding over the line chunks so that it stages its
//   group's mask table once in shared memory, C+1 rows (row C zero) of
//   32 K words (zero past W), each lane reading its own words through a
//   32-bit shared address kept in a register. The OR over groups is a
//   verdict byte per line (K1, K2g), zeroed by the entry and set with
//   atomicOr on its word by each group that accepts (K3's way), or a
//   word per line that the caller zeroed (K4, as at the register
//   widths); K4 differs from K1 in that word alone, and has its own
//   kernel so that a profile and the launch counts tell them apart.
// - K3 keeps its register schedule, a persistent grid striding over the
//   device pair list, with a warp a listed pair: it loads the pair's
//   group constants and reads the mask rows through L1 from the [G][C+1]
//   [W] table in device memory, since a block's warps may hold pairs of
//   several groups (the list is group-major, so neighbouring warps
//   mostly share one group's rows: 9.2 KB at C = 64 and W = 36). A grid
//   over (chunk, group) that stages each group's rows would leave most
//   blocks idle where a few groups hold the pairs, as on FakeCluster
//   lines under the sweep (the watch list's group is a candidate on
//   every line).
// What bounds them: the latency of one (line, group)'s chain of T steps
// (a shuffle, a vote and a ballot a step) where the pairs are few (long
// lines, K2g), the instructions of the pairs' warp-steps where they are
// many (K1 and K4 on an engine batch, B x G x T; K3, listed pairs x T),
// not bytes.
//
// Past 160 words (5120 states: one pattern of more than ~5100 positions,
// under KLOGS_MAX_PATTERN_POSITIONS raised past its default 4096) K1,
// K2g, K3 and K4 run the same split, still a warp a (line, group), with
// the state in shared memory: grouped_shift_smem_kernel (K1),
// grouped_chunk_smem_kernel (K2g, the carry [B][G][W] words),
// grouped_fused_smem_kernel (K4) and grouped_gated_smem_kernel (K3). A
// warp's state v and next state n are two W-word buffers in shared
// memory and lane l walks words l, l+32, ... in a loop of W/32 slices,
// so any width the compiler emits runs (a width whose two buffers do
// not fit a block's shared memory is refused: the wrapper raises
// GroupTooWideError). The step reads three words a slice (v, the
// constants, the mask row) and writes one; the carry crosses lanes by
// the rotating shuffle, live's bit is one broadcast word of v, and a
// vote over v & EX sends the warp, only where some exception is set, to
// a second pass that ORs each set bit's follow row. The K1/K2g/K4
// schedule (a block of lines of one group, groups on grid y) stages the
// group's constants and mask rows in shared memory where they fit beside
// the buffers in a quarter of the budget (four blocks an SM: up to 392
// words at C = 16, 170 at C = 64), else reads them through L1, as K3
// always does.
// What bounds them (measured on the H100): the latency of a warp's
// chain of steps (W/32 slices a step, each three loads and a shuffle),
// which more warps an SM hide, not bytes.
//
// K2 keeps chunk_nfa_wide at any width past 32 words (off the engine's
// path since K2g covers every width): a warp a line, its state in shared
// memory, and for every set state bit its whole follow row ORed from
// device memory through L2 in a coalesced pass.
//
// Every entry point returns the cudaError_t of its launch (0 = success)
// and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_WARPS = 8;      // lines (a warp each) per block, chunk
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;

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

// ---- K1 and K4: the shift-and-exceptions step ----------------------
// (see the note at the top)

constexpr int ID_AHEAD = 4;  // steps of class ids a thread loads ahead
// Blocks each SM should get before a block takes more than a warp of
// lines per group (fewer blocks copy the tables fewer times).
constexpr int BLOCKS_PER_SM = 8;

// Threads per block of the shift kernels (lines x groups): the register
// bound is 128 a thread at 512, 255 at 256.
template <int W>
__host__ __device__ constexpr int shift_threads() {
  return W <= 8 ? 512 : 256;
}

// Words per group of the shift kernels' shared tables: follow [S][W],
// mask [C+1][W] (row C all zero: the row an id outside [0, C) reads,
// which kills every state), then the step's constants [W][4].
template <int W>
__host__ __device__ constexpr size_t shift_group_words(int C) {
  return (size_t)32 * W * W + (size_t)(C + 1) * W + 4 * W;
}

// One group's constants, word j = (SH, SELF, RL, EX): in registers up
// to 8 words, else read from shared memory at each use (a warp is one
// group, so each read is a broadcast).
template <int W, bool REG = (W <= 8)>
struct ShiftConsts {
  uint4 k[W];
  __device__ __forceinline__ explicit ShiftConsts(const uint4* p) {
#pragma unroll
    for (int j = 0; j < W; ++j) k[j] = p[j];
  }
  __device__ __forceinline__ uint4 operator[](int j) const { return k[j]; }
};

template <int W>
struct ShiftConsts<W, false> {
  const uint4* p;
  __device__ __forceinline__ explicit ShiftConsts(const uint4* q) : p(q) {}
  __device__ __forceinline__ uint4 operator[](int j) const { return p[j]; }
};

template <int W>
__device__ __forceinline__ void load_row(uint32_t (&r)[W],
                                         const uint32_t* p) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 x = p4[q];
    r[4 * q] = x.x;
    r[4 * q + 1] = x.y;
    r[4 * q + 2] = x.z;
    r[4 * q + 3] = x.w;
  }
}

// Word lw of v, by a select tree (lw is the same at every step, so its
// bit tests leave the loop): log2(W) selects on the step's chain.
template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&v)[W], int lw) {
  uint32_t t[W];
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = v[j];
#pragma unroll
  for (int h = 1; h < W; h <<= 1)
#pragma unroll
    for (int j = 0; j + h < W; j += 2 * h) t[j] = (lw & h) ? t[j + h] : t[j];
  return t[0];
}

// One step, v' = reach(v) & m, with reach(v) split exactly:
//
//   shl1(v & SH) | (v & SELF) | (live in v ? RL : 0) | OR of follow[s], s in v & EX
//
// shl1 carries bit 31 of word j into bit 0 of word j+1. The first three
// terms are register arithmetic; f_g (the group's follow table [S][W]
// in shared memory) is read only for set exception bits, and the whole
// row is ORed (reach is a union, so rows that repeat a shift or self
// edge are exact). live is bit lsh of word lw; m is the class's mask
// row, loaded before the step (it depends on the class id only).
template <int W, bool REG>
__device__ __forceinline__ void shift_step(uint32_t (&v)[W],
                                           const ShiftConsts<W, REG>& k,
                                           int lw, int lsh,
                                           const uint32_t* f_g,
                                           const uint32_t (&m)[W]) {
  const uint32_t keep =
      (uint32_t)((int)(word_at<W>(v, lw) << (31 - lsh)) >> 31);
  uint32_t r[W], x = 0u, prev = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint4 c = k[j];
    const uint32_t a = v[j] & c.x;
    r[j] = __funnelshift_l(prev, a, 1) | (v[j] & c.y);
    x |= v[j] & c.w;
    prev = a;
  }
  if (x) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t bits = v[w] & k[w].w;
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        uint32_t row[W];
        load_row<W>(row, f_g + (size_t)(w * 32 + b) * W);
#pragma unroll
        for (int j = 0; j < W; ++j) r[j] |= row[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = (r[j] | (k[j].z & keep)) & m[j];
}

// Copy groups [g0, g0 + ng) into shared memory, gw words each: follow
// rows, mask rows, the zero row, constants.
template <int W>
__device__ __forceinline__ void stage_groups(
    uint32_t* dst, const uint32_t* __restrict__ follow,
    const uint32_t* __restrict__ mask, const uint32_t* __restrict__ consts,
    int g0, int ng, int C) {
  constexpr int S = 32 * W;
  const int fq = S * W / 4, mq = C * W / 4, zq = W / 4;  // in uint4
  const int per = fq + mq + zq + W;
  const uint4* f4 = reinterpret_cast<const uint4*>(follow);
  const uint4* m4 = reinterpret_cast<const uint4*>(mask);
  const uint4* k4 = reinterpret_cast<const uint4*>(consts);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int e = threadIdx.x; e < ng * per; e += blockDim.x) {
    const int gi = e / per, q = e % per, g = g0 + gi;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q < fq)
      x = f4[(size_t)g * fq + q];
    else if (q < fq + mq)
      x = m4[(size_t)g * mq + q - fq];
    else if (q >= fq + mq + zq)
      x = k4[(size_t)g * W + q - fq - mq - zq];
    d4[e] = x;
  }
}

// Steps [t0, t0 + ID_AHEAD) of one line's class ids (-1 past T), held
// in registers ID_AHEAD steps before they are stepped.
__device__ __forceinline__ void fetch_ids(int (&ids)[ID_AHEAD],
                                          const int16_t* __restrict__ row,
                                          int t0, int T) {
#pragma unroll
  for (int i = 0; i < ID_AHEAD; ++i)
    ids[i] = t0 + i < T ? row[t0 + i] : -1;
}

// The word offset of class id c's mask row: row C (all zero) for an id
// outside [0, C).
template <int W>
__device__ __forceinline__ int row_of(int c, int C) {
  return (int)min((unsigned)c, (unsigned)C) * W;
}

// One group's automaton stepped from state v (live is bit lsh of word
// lw) over one line's T class ids at `row`, v updated in place. f_g and
// m_g are the group's follow [S][W] and mask [C+1][W] words (row C all
// zero), in shared or device memory. cur holds the row offsets of steps
// [t0, t0 + ID_AHEAD), nxt the ids of the ID_AHEAD steps after, in
// flight; step i's mask row m is loaded during step i - 1, so no load is
// on the step's chain.
template <int W, bool REG>
__device__ __forceinline__ void scan_steps(uint32_t (&v)[W],
                                           const ShiftConsts<W, REG>& k,
                                           int lw, int lsh,
                                           const uint32_t* f_g,
                                           const uint32_t* m_g,
                                           const int16_t* __restrict__ row,
                                           int T, int C) {
  int cur[ID_AHEAD], nxt[ID_AHEAD];
  fetch_ids(nxt, row, 0, T);
#pragma unroll
  for (int i = 0; i < ID_AHEAD; ++i) cur[i] = row_of<W>(nxt[i], C);
  fetch_ids(nxt, row, ID_AHEAD, T);
  uint32_t m[W];
  load_row<W>(m, m_g + cur[0]);
  for (int t0 = 0; t0 < T; t0 += ID_AHEAD) {
    const int n = min(ID_AHEAD, T - t0);
#pragma unroll
    for (int i = 0; i < ID_AHEAD; ++i) {
      if (i < n) {
        uint32_t mn[W];
        load_row<W>(mn, m_g + (i + 1 < ID_AHEAD ? cur[i + 1]
                                                : row_of<W>(nxt[0], C)));
        shift_step<W>(v, k, lw, lsh, f_g, m);
#pragma unroll
        for (int j = 0; j < W; ++j) m[j] = mn[j];
      }
    }
#pragma unroll
    for (int i = 0; i < ID_AHEAD; ++i) cur[i] = row_of<W>(nxt[i], C);
    fetch_ids(nxt, row, t0 + 2 * ID_AHEAD, T);
  }
}

// One group's automaton, started at {live}, over one line's T class
// ids: whether it holds `acc` after the last step (scan_steps).
template <int W, bool REG>
__device__ __forceinline__ bool scan_line(const ShiftConsts<W, REG>& k,
                                          int lw, int lsh, int acc,
                                          const uint32_t* f_g,
                                          const uint32_t* m_g,
                                          const int16_t* __restrict__ row,
                                          int T, int C) {
  uint32_t v[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = j == lw ? 1u << lsh : 0u;
  scan_steps<W>(v, k, lw, lsh, f_g, m_g, row, T, C);
  return test_bit<W>(v, acc);
}

// K1 (SERIAL) and K4. Thread (l, g) = threadIdx.x (l + NL * g) steps
// line blockIdx.x * NL + l in group g of a chunk of GC groups, so a warp
// is 32 lines of one group. K1's block walks every chunk in turn and
// writes one byte per line; K4's block takes chunk blockIdx.y and ORs
// into the caller's zeroed word per line. The follow table holds, after
// its [G][S][W] words, the step's constants [G][W][4]. A chunk's last
// group may be short, and its surplus threads only stage and join the
// barriers. A thread reads its own line's class ids ID_AHEAD steps ahead
// (the GC threads of a line hit one L1 line), so the step loop holds
// neither a device-memory read on its chain nor a barrier: a chunk costs
// two barriers, around the copy of its tables.
template <int W, bool SERIAL>
__global__ void __launch_bounds__(shift_threads<W>())
    grouped_shift_kernel(const int16_t* __restrict__ cls, int B, int T,
                         const uint32_t* __restrict__ follow,
                         const uint32_t* __restrict__ mask, int G, int C,
                         int live, int acc, int NL, int GC,
                         void* __restrict__ out) {
  constexpr int S = 32 * W;
  const size_t gw = shift_group_words<W>(C);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hit = smem + GC * gw;
  const uint32_t* consts = follow + (size_t)G * S * W;
  const int l = threadIdx.x % NL, g = threadIdx.x / NL;
  const int line0 = blockIdx.x * NL;
  // A line past B steps row B - 1 and writes nothing.
  const int16_t* row = cls + (size_t)min(line0 + l, B - 1) * T;
  const uint32_t* f_g = smem + g * gw;
  const uint32_t* m_g = f_g + S * W;
  const uint4* c_g = reinterpret_cast<const uint4*>(m_g + (C + 1) * W);
  const int lw = live >> 5, lsh = live & 31;
  if (threadIdx.x < NL) hit[threadIdx.x] = 0u;
  const int c_begin = SERIAL ? 0 : (int)blockIdx.y;
  const int c_end = SERIAL ? (G + GC - 1) / GC : c_begin + 1;
  bool matched = false;
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int g0 = ch * GC, ng = min(GC, G - g0);
    __syncthreads();  // the last chunk's steps are done with the tables
    stage_groups<W>(smem, follow, mask, consts, g0, ng, C);
    __syncthreads();
    if (g >= ng) continue;  // warp-uniform: NL is a multiple of 32
    const ShiftConsts<W> k(c_g);
    if (scan_line<W>(k, lw, lsh, acc, f_g, m_g, row, T, C)) matched = true;
  }
  if (matched) hit[l] = 1u;
  __syncthreads();
  const int line = line0 + threadIdx.x;
  if (threadIdx.x < NL && line < B) {
    if (SERIAL)
      static_cast<uint8_t*>(out)[line] = hit[threadIdx.x] ? 1 : 0;
    else if (hit[threadIdx.x])
      atomicOr(static_cast<uint32_t*>(out) + line, 1u);
  }
}

// ---- K3: the gate's pair list, and a thread per pair ----------------
// (see the note at the top)

constexpr int PAIR_SLAB = 256;  // lines per block of the pair builder
constexpr int GATED_THREADS = 128;  // threads (pairs in flight) per K3 block

// Word wd of a line's gate: the words are read every `stride` 32-bit
// words (1: int32 words; 2: the low half of int64 words holding 32
// bits), bits at or past G are cleared, and a line past B has none.
__device__ __forceinline__ uint32_t gate_word(const uint32_t* __restrict__ gate,
                                              int B, int GW, int stride,
                                              int G, int line, int wd) {
  if (line >= B) return 0u;
  const uint32_t w = gate[((size_t)line * GW + wd) * stride];
  const int rest = G - 32 * wd;
  return rest >= 32 ? w : w & ((1u << rest) - 1u);
}

// Lane b's share of a warp's words w: how many lanes have bit b set.
__device__ __forceinline__ int bit_count(uint32_t w, int lane) {
  int c = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int n = __popc(__ballot_sync(FULL, (w >> b) & 1u));
    if (lane == b) c = n;
  }
  return c;
}

// Pass 1 of the pair list: block x reads lines [256 x, 256 x + 256)
// (a slab), counts[g * slabs + x] gets group g's set bits in it, and
// counts[G * slabs + x] its lines with any bit (candidate lines).
__global__ void __launch_bounds__(PAIR_SLAB)
    gate_pairs_count(const uint32_t* __restrict__ gate, int B, int GW,
                     int stride, int G, int* __restrict__ counts) {
  __shared__ int part[PAIR_SLAB / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slabs = gridDim.x, x = blockIdx.x;
  const int line = x * PAIR_SLAB + threadIdx.x;
  bool any = false;
  for (int wd = 0; wd < GW; ++wd) {
    const uint32_t w = gate_word(gate, B, GW, stride, G, line, wd);
    any = any || w != 0u;
    part[warp][lane] = bit_count(w, lane);
    __syncthreads();
    const int g = 32 * wd + threadIdx.x;
    if (threadIdx.x < 32 && g < G) {
      int n = 0;
#pragma unroll
      for (int k = 0; k < PAIR_SLAB / 32; ++k) n += part[k][threadIdx.x];
      counts[(size_t)g * slabs + x] = n;
    }
    __syncthreads();
  }
  const int n_any = __popc(__ballot_sync(FULL, any));
  if (lane == 0) part[warp][0] = n_any;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
#pragma unroll
    for (int k = 0; k < PAIR_SLAB / 32; ++k) n += part[k][0];
    counts[(size_t)G * slabs + x] = n;
  }
}

// Inclusive scan of x over the warp's lanes.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Between the passes: warp r of the grid scans row r of pass 1's
// [rows][slabs] counts in place into running sums along the slabs (32
// at a time, SCAN_AHEAD such pieces loaded, coalesced, before any is
// summed), so a row's last entry is its total.
constexpr int SCAN_WARPS = 8;
constexpr int SCAN_AHEAD = 8;

__global__ void __launch_bounds__(SCAN_WARPS * 32)
    gate_pairs_scan(int* __restrict__ counts, int rows, int slabs) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  int* row = counts + (size_t)r * slabs;
  int carry = 0;
  for (int x0 = 0; x0 < slabs; x0 += 32 * SCAN_AHEAD) {
    int v[SCAN_AHEAD];
#pragma unroll
    for (int k = 0; k < SCAN_AHEAD; ++k) {
      const int x = x0 + 32 * k + lane;
      v[k] = x < slabs ? row[x] : 0;
    }
#pragma unroll
    for (int k = 0; k < SCAN_AHEAD; ++k) {
      if (x0 + 32 * k >= slabs) break;  // warp-uniform
      const int x = x0 + 32 * k + lane;
      const int sum = warp_scan(v[k], lane) + carry;
      if (x < slabs) row[x] = sum;
      carry = __shfl_sync(FULL, sum, 31);
    }
  }
}

// Pass 2: after the scan, group g's pairs start past the totals of the
// groups before it (each warp sums them, 32 groups a word, from the
// rows' last entries), and its pairs of slab x past incl[g * slabs + x]
// less their count. Each set bit (line, g) lands at that start plus the
// set bits of g in the slab's lower warps and lower lanes: pairs[]
// holds g * B + line, group-major, lines ascending. Block 0 writes the
// pair count to *n_pairs and the stats: candidate lines (row G's
// total), ceil(that / tile), ceil(B / tile).
__global__ void __launch_bounds__(PAIR_SLAB)
    gate_pairs_scatter(const uint32_t* __restrict__ gate, int B, int GW,
                       int stride, int G, const int* __restrict__ incl,
                       int tile, int* __restrict__ pairs,
                       int* __restrict__ n_pairs,
                       long long* __restrict__ stats) {
  __shared__ int part[PAIR_SLAB / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slabs = gridDim.x, x = blockIdx.x;
  const int line = x * PAIR_SLAB + threadIdx.x;
  const uint32_t below = (1u << lane) - 1u;
  int base = 0;  // the pairs of groups [0, 32 wd)
  for (int wd = 0; wd < GW; ++wd) {
    const uint32_t w = gate_word(gate, B, GW, stride, G, line, wd);
    part[warp][lane] = bit_count(w, lane);
    __syncthreads();
    // Lane b: where this warp's pairs of group 32 wd + b start.
    int before = 0, all = 0;
#pragma unroll
    for (int k = 0; k < PAIR_SLAB / 32; ++k) {
      const int n = part[k][lane];
      all += n;
      before += k < warp ? n : 0;
    }
    const int g_lane = 32 * wd + lane;
    const int* row = incl + (size_t)g_lane * slabs;
    const int total = g_lane < G ? row[slabs - 1] : 0;
    const int upto = warp_scan(total, lane);  // groups [32 wd, g_lane]
    const int start =
        g_lane < G ? base + upto - total + row[x] - all + before : 0;
    base += __shfl_sync(FULL, upto, 31);
    __syncthreads();  // part is rewritten for the next word
#pragma unroll 4
    for (int b = 0; b < 32; ++b) {
      const bool mine = (w >> b) & 1u;
      const uint32_t ball = __ballot_sync(FULL, mine);
      const int at = __shfl_sync(FULL, start, b) + __popc(ball & below);
      if (mine) pairs[at] = (32 * wd + b) * B + line;
    }
  }
  if (x == 0 && threadIdx.x == 0) {
    *n_pairs = base;
    const long long cand = incl[(size_t)G * slabs + slabs - 1];
    stats[0] = cand;
    stats[1] = (cand + tile - 1) / tile;
    stats[2] = ((long long)B + tile - 1) / tile;
  }
}

// Sets line's verdict byte in `out` (bytes, zeroed before the launch)
// to 1.
__device__ __forceinline__ void set_verdict(uint32_t* out, int line) {
  atomicOr(out + (line >> 2), 1u << (8 * (line & 3)));
}

// K3: thread i of the grid takes pairs i, i + (grid threads), ... of
// the list's first *n_pairs entries; pair p = g * B + line is group g's
// automaton over line's class ids, read from the wrapper's tables in
// device memory (follow [G][S][W] then the constants [G][W][4]; mask
// [G][C+1][W], row C all zero). An accepting pair sets its line's byte.
template <int W>
__global__ void __launch_bounds__(GATED_THREADS)
    grouped_nfa_gated_kernel(const int16_t* __restrict__ cls, int B, int T,
                             const uint32_t* __restrict__ follow,
                             const uint32_t* __restrict__ mask, int G, int C,
                             int live, int acc, const int* __restrict__ pairs,
                             const int* __restrict__ n_pairs,
                             uint32_t* __restrict__ out) {
  constexpr int S = 32 * W;
  const uint4* consts =
      reinterpret_cast<const uint4*>(follow + (size_t)G * S * W);
  const int lw = live >> 5, lsh = live & 31;
  const int n = *n_pairs;
  for (int i = blockIdx.x * GATED_THREADS + threadIdx.x; i < n;
       i += gridDim.x * GATED_THREADS) {
    const unsigned p = (unsigned)pairs[i];
    const int g = (int)(p / (unsigned)B), line = (int)(p - g * (unsigned)B);
    const ShiftConsts<W> k(consts + (size_t)g * W);
    if (scan_line<W>(k, lw, lsh, acc, follow + (size_t)g * S * W,
                     mask + (size_t)g * (C + 1) * W,
                     cls + (size_t)line * T, T, C))
      set_verdict(out, line);
  }
}

// ---- K2g: a chunk of long lines through the grouped automata ---------
// (see the note at the top)

constexpr int GCHUNK_THREADS = 32;  // groups of one line per K2g block

template <int W>
__device__ __forceinline__ void store_row(uint32_t* p,
                                          const uint32_t (&r)[W]) {
  uint4* p4 = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    p4[q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// K2g: block (x, y) is line x's groups [32 y, 32 y + 32), a thread each.
// The thread reads its (line, group) state from v0 [B][G][W], steps it
// over the line's T class ids (K1's step, tables in device memory as
// K3 reads them), writes it to vout and, where it holds `acc`, sets the
// line's verdict byte in `out` (zeroed before the launch).
template <int W>
__global__ void __launch_bounds__(GCHUNK_THREADS)
    grouped_chunk_kernel(const int16_t* __restrict__ cls, int T,
                         const uint32_t* __restrict__ follow,
                         const uint32_t* __restrict__ mask, int G, int C,
                         int live, int acc, const uint32_t* __restrict__ v0,
                         uint32_t* __restrict__ vout,
                         uint32_t* __restrict__ out) {
  constexpr int S = 32 * W;
  const int line = blockIdx.x;
  const int g = blockIdx.y * GCHUNK_THREADS + threadIdx.x;
  if (g >= G) return;
  const uint4* consts =
      reinterpret_cast<const uint4*>(follow + (size_t)G * S * W);
  const ShiftConsts<W> k(consts + (size_t)g * W);
  const size_t at = ((size_t)line * G + g) * W;
  uint32_t v[W];
  load_row<W>(v, v0 + at);
  scan_steps<W>(v, k, live >> 5, live & 31, follow + (size_t)g * S * W,
                mask + (size_t)g * (C + 1) * W, cls + (size_t)line * T, T,
                C);
  store_row<W>(vout + at, v);
  if (test_bit<W>(v, acc)) set_verdict(out, line);
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

// ---- past 32 words: the shift step over a warp (K1, K2g, K3, K4) ----
// (see the note at the top)

constexpr int WIDE_WARPS = 8;  // (line, group) pairs, a warp each, a block
constexpr int WIDE_MAX_K = 5;  // state words a lane: up to 160 words

// x[i] for an i known to the warp only at run time (static indexing, so
// the array stays in registers).
template <int K>
__device__ __forceinline__ uint32_t slot(const uint32_t (&x)[K], int i) {
  uint32_t w = 0u;
#pragma unroll
  for (int q = 0; q < K; ++q)
    if (q == i) w = x[q];
  return w;
}

// What a lane of a wide warp keeps in registers for its whole scan: its
// words of the group's constants (SH, SELF, RL, EX), live's bit in its
// words (0 but in live's lane) and its lane number.
template <int K>
struct WideLane {
  uint32_t sh[K], sf[K], rl[K], ex[K], lv[K];
  int lane;
  __device__ __forceinline__ WideLane(const uint4* c_g, int W, int live) {
    lane = (int)(threadIdx.x & 31u);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = lane + 32 * i;
      const uint4 q = j < W ? c_g[j] : make_uint4(0u, 0u, 0u, 0u);
      sh[i] = q.x;
      sf[i] = q.y;
      rl[i] = q.z;
      ex[i] = q.w;
      lv[i] = j == (live >> 5) ? 1u << (live & 31) : 0u;
    }
  }
};

// A wide warp's mask rows, staged: the lane's words of row c (row C, all
// zero, for an id outside [0, C)) of a group's [C+1][32 K] table in
// shared memory (rows of 32 K words, zero past W: a lane reads word
// lane + 32 i of a row), through the 32-bit shared address of its word
// of row 0, passed through opaque() so that the compiler keeps it in a
// register.
template <int K>
struct StagedRows {
  uint32_t m_lane;
  int C;
  __device__ __forceinline__ StagedRows(const uint32_t* m_s, int C_)
      : m_lane(opaque(smem_addr(m_s + (threadIdx.x & 31u)))), C(C_) {}
  __device__ __forceinline__ void operator()(uint32_t (&m)[K], int c) const {
    const uint32_t row = m_lane + min((unsigned)c, (unsigned)C) * (128u * K);
#pragma unroll
    for (int i = 0; i < K; ++i) m[i] = lds(row + 128u * i);
  }
};

// The same rows read through L1 from a group's [C+1][W] table in device
// memory (row C all zero): the lane's word of row 0, and how many of its
// K slots lie inside W (0 past them).
template <int K>
struct CachedRows {
  const uint32_t* m_lane;
  int W, C, n;
  __device__ __forceinline__ CachedRows(const uint32_t* m_g, int W_, int C_)
      : m_lane(m_g + (threadIdx.x & 31u)),
        W(W_),
        C(C_),
        n((W_ - (int)(threadIdx.x & 31u) + 31) / 32) {}
  __device__ __forceinline__ void operator()(uint32_t (&m)[K], int c) const {
    const uint32_t* row = m_lane + min((unsigned)c, (unsigned)C) * W;
#pragma unroll
    for (int i = 0; i < K; ++i) m[i] = i < n ? __ldg(row + 32 * i) : 0u;
  }
};

// One step of a warp's (line, group), v' = reach(v) & m, reach split as
// in shift_step. Word j = lane + 32 i is v[i] of the lane. shl1 carries
// bit 31 of word j-1 into word j: lane l's K top bits of v & SH go, in
// one shuffle, to lane l+1 (lane 31's to lane 0, whose slot i takes
// slot i-1's bit: word 32i-1 is lane 31's). live's bit is found by a
// vote. f_g is the group's follow table [S][W] in device memory; each
// set exception bit's row is read by the warp, a word a lane a pass.
template <int K>
__device__ __forceinline__ void wide_shift_step(
    uint32_t (&v)[K], const WideLane<K>& w, const uint32_t* __restrict__ f_g,
    int W, const uint32_t (&m)[K]) {
  uint32_t a[K], r[K], top = 0u, exc = 0u, live = 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    a[i] = v[i] & w.sh[i];
    top |= (a[i] >> 31) << i;
    exc |= v[i] & w.ex[i];
    live |= v[i] & w.lv[i];
  }
  // Lane l - 1's: a source lane is taken modulo 32, so lane 0 reads 31.
  const uint32_t prev = __shfl_sync(FULL, top, w.lane - 1);
  const uint32_t keep = __any_sync(FULL, live != 0u) ? FULL : 0u;
  const uint32_t carry = w.lane ? prev : prev << 1;
#pragma unroll
  for (int i = 0; i < K; ++i)
    r[i] = (a[i] << 1) | ((carry >> i) & 1u) | (v[i] & w.sf[i]) |
           (w.rl[i] & keep);
  uint32_t lanes = __ballot_sync(FULL, exc != 0u);
  while (lanes) {  // warp-uniform, as every loop below
    const int q = __ffs(lanes) - 1;
    lanes &= lanes - 1u;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      uint32_t bits = __shfl_sync(FULL, v[i] & w.ex[i], q);
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const uint32_t* row = f_g + (size_t)((q + 32 * i) * 32 + b) * W;
#pragma unroll
        for (int i2 = 0; i2 < K; ++i2) {
          const int j = w.lane + 32 * i2;
          if (j < W) r[i2] |= __ldg(row + j);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = r[i] & m[i];
}

// A warp's (line, group) stepped from v over the line's T class ids at
// `row`: lane l holds the id of step t0 + l (-1 past T), the next 32
// loaded a tile ahead; step t's mask row (`rows`: StagedRows or
// CachedRows) is read during step t - 1.
template <int K, class Rows>
__device__ __forceinline__ void wide_shift_scan(
    uint32_t (&v)[K], const WideLane<K>& w, const Rows& rows,
    const uint32_t* __restrict__ f_g, int W, const int16_t* __restrict__ row,
    int T) {
  int cur = w.lane < T ? row[w.lane] : -1;
  int nxt = 32 + w.lane < T ? row[32 + w.lane] : -1;
  uint32_t m[K];
  rows(m, __shfl_sync(FULL, cur, 0));
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int n = min(32, T - t0);
    for (int tt = 0; tt < n; ++tt) {
      const int cn = __shfl_sync(FULL, tt < 31 ? cur : nxt, (tt + 1) & 31);
      uint32_t mn[K];
      rows(mn, cn);
      wide_shift_step<K>(v, w, f_g, W, m);
#pragma unroll
      for (int i = 0; i < K; ++i) m[i] = mn[i];
    }
    cur = nxt;
    nxt = t0 + 64 + w.lane < T ? row[t0 + 64 + w.lane] : -1;
  }
}

// Whether a wide warp's state holds state s (word s/32 is slot s/32/32
// of lane s/32 % 32); every lane takes part in the shuffle.
template <int K>
__device__ __forceinline__ bool wide_holds(const uint32_t (&v)[K], int s) {
  const int sw = s >> 5;
  return (__shfl_sync(FULL, slot<K>(v, sw >> 5), sw & 31) >> (s & 31)) & 1u;
}

// Which kernel a wide_shift_pairs block serves: K1 (a verdict byte a
// line), K2g (the state carried in v0 and out in vout, a verdict byte a
// line) or K4 (a zeroed word a line).
enum WideMode { WIDE_K1, WIDE_K2G, WIDE_K4 };

// Block (x, g): group g's automaton, warp w on line ch * WIDE_WARPS + w
// for the chunks ch = x, x + gridDim.x, ... of WIDE_WARPS lines. The
// block stages the group's mask rows (rows 0..C-1 of mask [G][MR][W],
// MR = C, or C + 1 for a table that ends in a zero row) and a zero row
// in shared memory once, in rows of 32 K words (zero past W); follow
// holds [G][S][W] words, then the constants [G][W][4]. With v0 (K2g)
// the state comes from v0 and goes to vout, [B][G][W] words; else (K1,
// K4) it starts at {live}. A pair that holds acc after its last step
// sets its line's byte in out (K1, K2g; zeroed before the launch) or
// ORs 1 into its line's word (K4, `word_out`; zeroed by the caller).
// Not inlined: K1's, K2g's and K4's kernels call one copy of it a
// width, which keeps what nvcc compiles to one body a width.
template <int K>
__device__ __noinline__ void wide_shift_pairs(
    const int16_t* __restrict__ cls, int B, int T,
    const uint32_t* __restrict__ follow, const uint32_t* __restrict__ mask,
    int G, int W, int C, int MR, int live, int acc,
    const uint32_t* __restrict__ v0, uint32_t* __restrict__ vout,
    uint32_t* __restrict__ out, bool word_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int WP = 32 * K;  // words of a staged mask row
  const int g = blockIdx.y, S = 32 * W;
  const uint32_t* m_g = mask + (size_t)g * MR * W;
  for (int e = threadIdx.x; e < (C + 1) * WP; e += blockDim.x) {
    const int r = e / WP, j = e % WP;
    smem[e] = r < C && j < W ? m_g[r * W + j] : 0u;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const uint32_t* f_g = follow + (size_t)g * S * W;
  const WideLane<K> w(
      reinterpret_cast<const uint4*>(follow + (size_t)G * S * W) +
          (size_t)g * W,
      W, live);
  const StagedRows<K> rows(smem, C);
  const int chunks = (B + WIDE_WARPS - 1) / WIDE_WARPS;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int line = ch * WIDE_WARPS + warp;
    if (line >= B) break;  // the whole warp; later chunks only go further
    const size_t at = ((size_t)line * G + g) * W;
    uint32_t v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = w.lane + 32 * i;
      if (v0 != nullptr)
        v[i] = j < W ? v0[at + j] : 0u;
      else
        v[i] = w.lv[i];
    }
    wide_shift_scan<K>(v, w, rows, f_g, W, cls + (size_t)line * T, T);
    if (v0 != nullptr) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = w.lane + 32 * i;
        if (j < W) vout[at + j] = v[i];
      }
    }
    if (wide_holds<K>(v, acc) && w.lane == 0) {
      if (word_out)
        atomicOr(out + line, 1u);
      else
        set_verdict(out, line);
    }
  }
}

// K1 past 32 words.
template <int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_shift_wide_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const uint32_t* __restrict__ v0,
                              uint32_t* __restrict__ vout,
                              uint32_t* __restrict__ out) {
  wide_shift_pairs<K>(cls, B, T, follow, mask, G, W, C, C, live, acc,
                      nullptr, nullptr, out, false);
}

// K2g past 32 words (mask [G][C+1][W], as K3 reads it).
template <int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_chunk_wide_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const uint32_t* __restrict__ v0,
                              uint32_t* __restrict__ vout,
                              uint32_t* __restrict__ out) {
  wide_shift_pairs<K>(cls, B, T, follow, mask, G, W, C, C + 1, live, acc, v0,
                      vout, out, false);
}

// K4 past 32 words: K1's schedule, a word a line.
template <int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_fused_wide_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const uint32_t* __restrict__ v0,
                              uint32_t* __restrict__ vout,
                              uint32_t* __restrict__ out) {
  wide_shift_pairs<K>(cls, B, T, follow, mask, G, W, C, C, live, acc,
                      nullptr, nullptr, out, true);
}

// K3 past 32 words: warp i of a persistent grid takes pairs i, i + (grid
// warps), ... of the first *n_pairs entries of the list (pair p = g * B
// + line, group-major). For each it loads group g's constants, runs
// the wide step from {live} over line's class ids, the mask rows read
// through L1 from mask [G][C+1][W] (a block's warps may hold pairs of
// different groups, so nothing is staged; neighbouring warps mostly
// share a group, so its rows are a few cached lines), and sets the
// line's verdict byte where acc holds (out zeroed before the launch).
template <int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_gated_wide_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const int* __restrict__ pairs,
                              const int* __restrict__ n_pairs,
                              uint32_t* __restrict__ out) {
  const int S = 32 * W;
  const uint4* consts =
      reinterpret_cast<const uint4*>(follow + (size_t)G * S * W);
  const int n = *n_pairs;
  for (int i = blockIdx.x * WIDE_WARPS + (int)(threadIdx.x >> 5); i < n;
       i += gridDim.x * WIDE_WARPS) {
    const unsigned p = (unsigned)pairs[i];
    const int g = (int)(p / (unsigned)B), line = (int)(p - g * (unsigned)B);
    const WideLane<K> w(consts + (size_t)g * W, W, live);
    const CachedRows<K> rows(mask + (size_t)g * (C + 1) * W, W, C);
    uint32_t v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = w.lv[k];
    wide_shift_scan<K>(v, w, rows, follow + (size_t)g * S * W, W,
                       cls + (size_t)line * T, T);
    if (wide_holds<K>(v, acc) && w.lane == 0) set_verdict(out, line);
  }
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

// ---- past 160 words: the shift step, the state in shared memory ------
// (see the note at the top)
//
// A warp still owns one (line, group), lane l the words l, l+32, ...,
// but the state v and the next state n are the warp's two W-word
// buffers in shared memory, walked by a loop of W/32 slices, so any
// width runs. The step's math is wide_shift_step's: per slice, the lane
// reads its word of v, of the constants and of the class's mask row;
// shl1's carry into word j is bit 31 of word j-1 of v & SH, passed by a
// rotating shuffle (lane 0 takes lane 31's of the slice before); live's
// bit is one broadcast word of v; a vote finds a set exception, and a
// second pass over the slices, only then, ballots v & EX and ORs each
// set bit's follow row (masked) into n, a word a lane. Every lane
// touches its own words only, and the one word read across lanes (v's
// live word) is read after the __syncwarp that ends the step before.
// (Skipping the slices that are zero, and loading eight slices' words
// ahead, each ran slower on the H100: PERF.md.)

// A warp's tables past 160 words: the group's [W] (SH, SELF, RL, EX)
// constant words and its mask rows, STAGED in shared memory (C+1 rows,
// row C zero), else read through L1 from device memory (an id outside
// [0, C) reads zeros).
template <bool STAGED>
struct SmemTables;

template <>
struct SmemTables<true> {
  const uint4* k;     // [W]
  const uint32_t* m;  // [C + 1][W]
  int W, C;
  __device__ __forceinline__ uint4 consts(int j) const { return k[j]; }
  __device__ __forceinline__ uint32_t ex(int j) const { return k[j].w; }
  __device__ __forceinline__ const uint32_t* row(int c) const {
    return m + (size_t)min((unsigned)c, (unsigned)C) * W;
  }
  __device__ __forceinline__ uint32_t word(const uint32_t* r, int j) const {
    return r[j];
  }
};

template <>
struct SmemTables<false> {
  const uint4* k;     // [W]
  const uint32_t* m;  // [C or C + 1][W]
  int W, C;
  __device__ __forceinline__ uint4 consts(int j) const { return __ldg(k + j); }
  __device__ __forceinline__ uint32_t ex(int j) const {
    return __ldg(reinterpret_cast<const uint32_t*>(k + j) + 3);
  }
  __device__ __forceinline__ const uint32_t* row(int c) const {
    return (unsigned)c < (unsigned)C ? m + (size_t)c * W : nullptr;
  }
  __device__ __forceinline__ uint32_t word(const uint32_t* r, int j) const {
    return r != nullptr ? __ldg(r + j) : 0u;
  }
};

// One step, n = reach(v) & mask[c], of a warp's (line, group) whose
// state v and next state n are W-word buffers in shared memory (lane l:
// words l, l+32, ...); live is bit lsh of word lw; f_g is the group's
// follow table [S][W] in device memory. Ends with the warp's
// __syncwarp.
template <bool STAGED>
__device__ __forceinline__ void smem_shift_step(
    const uint32_t* __restrict__ v, uint32_t* __restrict__ n,
    const SmemTables<STAGED>& t, const uint32_t* __restrict__ f_g, int lane,
    int lw, int lsh, int c) {
  const int W = t.W;
  const uint32_t keep = (v[lw] >> lsh) & 1u ? FULL : 0u;
  const uint32_t* mr = t.row(c);
  uint32_t exc = 0u, carry = 0u;
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < W;
    const uint32_t x = in ? v[j] : 0u;
    const uint4 k = in ? t.consts(j) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t m = in ? t.word(mr, j) : 0u;
    const uint32_t a = x & k.x;
    // Lane l - 1's top bit (a source lane is taken modulo 32: lane 0
    // reads lane 31's, which is lane 0's carry into the next slice).
    const uint32_t prev = __shfl_sync(FULL, a >> 31, lane - 1);
    const uint32_t cin = lane ? prev : carry;
    carry = prev;
    exc |= x & k.w;
    if (in) n[j] = ((a << 1) | cin | (x & k.y) | (k.z & keep)) & m;
  }
  if (__any_sync(FULL, exc != 0u)) {  // warp-uniform, as every loop below
    for (int j0 = 0; j0 < W; j0 += 32) {
      const int j = j0 + lane;
      const uint32_t e = j < W ? v[j] & t.ex(j) : 0u;
      uint32_t lanes = __ballot_sync(FULL, e != 0u);
      while (lanes) {
        const int q = __ffs(lanes) - 1;
        lanes &= lanes - 1u;
        uint32_t bits = __shfl_sync(FULL, e, q);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1u;
          const uint32_t* row = f_g + (size_t)((j0 + q) * 32 + b) * W;
          for (int i = lane; i < W; i += 32)
            n[i] |= __ldg(row + i) & t.word(mr, i);
        }
      }
    }
  }
  __syncwarp();
}

// A warp's (line, group) stepped from the state in v over the line's T
// class ids at `row` (lane l holds the id of step t0 + l, the next 32
// loaded a tile ahead), v and n swapped after each step; returns the
// buffer that holds the last state.
template <bool STAGED>
__device__ __forceinline__ uint32_t* smem_shift_scan(
    uint32_t* v, uint32_t* n, const SmemTables<STAGED>& t,
    const uint32_t* __restrict__ f_g, int lane, int lw, int lsh,
    const int16_t* __restrict__ row, int T) {
  int cur = lane < T ? row[lane] : -1;
  int nxt = 32 + lane < T ? row[32 + lane] : -1;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int cnt = min(32, T - t0);
    for (int tt = 0; tt < cnt; ++tt) {
      smem_shift_step<STAGED>(v, n, t, f_g, lane, lw, lsh,
                              __shfl_sync(FULL, cur, tt));
      uint32_t* s = v;
      v = n;
      n = s;
    }
    cur = nxt;
    nxt = t0 + 64 + lane < T ? row[t0 + 64 + lane] : -1;
  }
  return v;
}

// Block (x, g): group g's automaton, warp w on line ch * nw + w for the
// chunks ch = x, x + gridDim.x, ... of nw = blockDim.x / 32 lines, as
// wide_shift_pairs, with the state in shared memory. STAGED: the block
// first copies its group's constants ([W] words of the follow buffer's
// [G][W][4] tail, as four [W] arrays) and mask rows (rows 0..C-1 of
// mask [G][MR][W], then a zero row) into shared memory; the warps'
// buffers follow them. v0/vout, out and word_out as in
// wide_shift_pairs. Not inlined: one body a STAGED for K1's, K2g's and
// K4's kernels.
template <bool STAGED>
__device__ __noinline__ void smem_shift_pairs(
    const int16_t* __restrict__ cls, int B, int T,
    const uint32_t* __restrict__ follow, const uint32_t* __restrict__ mask,
    int G, int W, int C, int MR, int live, int acc,
    const uint32_t* __restrict__ v0, uint32_t* __restrict__ vout,
    uint32_t* __restrict__ out, bool word_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int g = blockIdx.y, nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t S = (size_t)32 * W;
  const uint32_t* m_g = mask + (size_t)g * MR * W;
  const uint4* c_g =
      reinterpret_cast<const uint4*>(follow + (size_t)G * S * W) +
      (size_t)g * W;
  SmemTables<STAGED> t;
  t.W = W;
  t.C = C;
  uint32_t* buf = smem;
  if constexpr (STAGED) {
    uint4* k_s = reinterpret_cast<uint4*>(smem);
    for (int e = threadIdx.x; e < W; e += blockDim.x) k_s[e] = c_g[e];
    for (int e = threadIdx.x; e < (C + 1) * W; e += blockDim.x)
      smem[4 * W + e] = e < C * W ? m_g[e] : 0u;
    t.k = k_s;
    t.m = smem + 4 * W;
    buf = smem + (size_t)(C + 5) * W;
    __syncthreads();
  } else {
    t.k = c_g;
    t.m = m_g;
  }
  const uint32_t* f_g = follow + (size_t)g * S * W;
  const int lw = live >> 5, lsh = live & 31;
  uint32_t* v = buf + (size_t)warp * 2 * W;
  uint32_t* n = v + W;
  const int chunks = (B + nw - 1) / nw;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int line = ch * nw + warp;
    if (line >= B) break;  // the whole warp; later chunks only go further
    const size_t at = ((size_t)line * G + g) * W;
    for (int j = lane; j < W; j += 32)
      v[j] = v0 != nullptr ? v0[at + j] : (j == lw ? 1u << lsh : 0u);
    __syncwarp();
    const uint32_t* f = smem_shift_scan<STAGED>(v, n, t, f_g, lane, lw, lsh,
                                                cls + (size_t)line * T, T);
    if (v0 != nullptr)
      for (int j = lane; j < W; j += 32) vout[at + j] = f[j];
    if (lane == 0 && (f[acc >> 5] >> (acc & 31)) & 1u) {
      if (word_out)
        atomicOr(out + line, 1u);
      else
        set_verdict(out, line);
    }
    __syncwarp();  // every lane is done with f before the next line
  }
}

// K1 past 160 words.
template <bool STAGED>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_shift_smem_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const uint32_t* __restrict__ v0,
                              uint32_t* __restrict__ vout,
                              uint32_t* __restrict__ out) {
  smem_shift_pairs<STAGED>(cls, B, T, follow, mask, G, W, C, C, live, acc,
                           nullptr, nullptr, out, false);
}

// K2g past 160 words (mask [G][C+1][W]).
template <bool STAGED>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_chunk_smem_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const uint32_t* __restrict__ v0,
                              uint32_t* __restrict__ vout,
                              uint32_t* __restrict__ out) {
  smem_shift_pairs<STAGED>(cls, B, T, follow, mask, G, W, C, C + 1, live,
                           acc, v0, vout, out, false);
}

// K4 past 160 words: K1's schedule, a word a line.
template <bool STAGED>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_fused_smem_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const uint32_t* __restrict__ v0,
                              uint32_t* __restrict__ vout,
                              uint32_t* __restrict__ out) {
  smem_shift_pairs<STAGED>(cls, B, T, follow, mask, G, W, C, C, live, acc,
                           nullptr, nullptr, out, true);
}

// K3 past 160 words: grouped_gated_wide_kernel's persistent grid (warp i
// takes pairs i, i + (grid warps), ... of the first *n_pairs), each
// warp's state in its two W-word buffers of shared memory, its group's
// tables read through L1 (mask [G][C+1][W]).
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    grouped_gated_smem_kernel(const int16_t* __restrict__ cls, int B, int T,
                              const uint32_t* __restrict__ follow,
                              const uint32_t* __restrict__ mask, int G, int W,
                              int C, int live, int acc,
                              const int* __restrict__ pairs,
                              const int* __restrict__ n_pairs,
                              uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t S = (size_t)32 * W;
  const uint4* consts =
      reinterpret_cast<const uint4*>(follow + (size_t)G * S * W);
  const int lw = live >> 5, lsh = live & 31;
  uint32_t* v = smem + (size_t)warp * 2 * W;
  uint32_t* n = v + W;
  const int np = *n_pairs;
  for (int i = blockIdx.x * nw + warp; i < np; i += gridDim.x * nw) {
    const unsigned p = (unsigned)pairs[i];
    const int g = (int)(p / (unsigned)B), line = (int)(p - g * (unsigned)B);
    SmemTables<false> t;
    t.k = consts + (size_t)g * W;
    t.m = mask + (size_t)g * (C + 1) * W;
    t.W = W;
    t.C = C;
    for (int j = lane; j < W; j += 32) v[j] = j == lw ? 1u << lsh : 0u;
    __syncwarp();
    const uint32_t* f =
        smem_shift_scan<false>(v, n, t, follow + (size_t)g * S * W, lane, lw,
                               lsh, cls + (size_t)line * T, T);
    if (lane == 0 && (f[acc >> 5] >> (acc & 31)) & 1u) set_verdict(out, line);
    __syncwarp();  // every lane is done with f before the next pair
  }
}

// ---- K2's generic wide kernel (past 32 words) -------------------------
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

// Warps (lines) per block for chunk_nfa_wide: up to 4, as many as fit
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
size_t shift_smem_bytes(int C, int nl, int gc) {
  return (gc * shift_group_words<W>(C) + nl) * 4;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Blocks of a persistent grid: as many as every SM holds at once.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (per_sm > 0 ? per_sm : 1) * sm_count();
}

// K3: a persistent grid over the pair list (its length is on the
// device), never more blocks than B * G pairs could fill.
template <int W>
cudaError_t launch_gated(const int16_t* cls, int B, int T,
                         const uint32_t* follow, const uint32_t* mask, int G,
                         int C, int live, int acc, const int* pairs,
                         const int* n_pairs, uint32_t* out,
                         cudaStream_t stream) {
  static const int resident =
      resident_blocks(grouped_nfa_gated_kernel<W>, GATED_THREADS, 0);
  const long long need =
      ((long long)B * G + GATED_THREADS - 1) / GATED_THREADS;
  const int blocks = (int)(need < resident ? need : resident);
  grouped_nfa_gated_kernel<W><<<blocks, GATED_THREADS, 0, stream>>>(
      cls, B, T, follow, mask, G, C, live, acc, pairs, n_pairs, out);
  return cudaGetLastError();
}

// K1 (SERIAL: chunks in turn inside a block, a byte per line) or K4
// (chunks along grid y, a zeroed word per line ORed).
template <int W, bool SERIAL>
cudaError_t launch_shift(const int16_t* cls, int B, int T,
                         const uint32_t* follow, const uint32_t* mask, int G,
                         int C, int live, int acc, void* out,
                         cudaStream_t stream) {
  constexpr int maxt = shift_threads<W>();
  // The most groups whose tables fit beside a warp of lines each; then
  // as few chunks as that allows, evened out (never more groups).
  int gc = G < maxt / 32 ? G : maxt / 32;
  while (gc > 0 && shift_smem_bytes<W>(C, 32, gc) > (size_t)MAX_SMEM) --gc;
  if (gc == 0) return cudaErrorInvalidValue;
  const int chunks = (G + gc - 1) / gc;
  gc = (G + chunks - 1) / chunks;
  // Lines per block: a warp of each group, more only where every SM
  // still gets BLOCKS_PER_SM blocks.
  const long long blocks32 =
      (long long)((B + 31) / 32) * (SERIAL ? 1 : chunks);
  long long k = blocks32 / ((long long)sm_count() * BLOCKS_PER_SM);
  if (k > maxt / (32 * gc)) k = maxt / (32 * gc);
  if (k < 1) k = 1;
  while (k > 1 && shift_smem_bytes<W>(C, 32 * (int)k, gc) > (size_t)MAX_SMEM)
    --k;
  const int nl = 32 * (int)k;
  const size_t smem = shift_smem_bytes<W>(C, nl, gc);
  cudaError_t e = allow_smem(grouped_shift_kernel<W, SERIAL>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + nl - 1) / nl, SERIAL ? 1 : chunks);
  grouped_shift_kernel<W, SERIAL><<<grid, nl * gc, smem, stream>>>(
      cls, B, T, follow, mask, G, C, live, acc, nl, gc, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_grouped_chunk(const int16_t* cls, int B, int T,
                                 const uint32_t* follow, const uint32_t* mask,
                                 int G, int C, int live, int acc,
                                 const uint32_t* v0, uint32_t* vout,
                                 uint32_t* out, cudaStream_t stream) {
  const dim3 grid(B, (G + GCHUNK_THREADS - 1) / GCHUNK_THREADS);
  grouped_chunk_kernel<W><<<grid, GCHUNK_THREADS, 0, stream>>>(
      cls, T, follow, mask, G, C, live, acc, v0, vout, out);
  return cudaGetLastError();
}

// K1, K2g or K4 (MODE) past 32 words, K words a lane: blocks of
// WIDE_WARPS lines, grid y the groups, grid x as many line chunks as
// fill the card twice over (each block stages its group's mask table
// once and strides over the chunks). out is zeroed by the caller.
template <int K, WideMode MODE>
cudaError_t launch_shift_wide(const int16_t* cls, int B, int T,
                              const uint32_t* follow, const uint32_t* mask,
                              int G, int W, int C, int live, int acc,
                              const uint32_t* v0, uint32_t* vout,
                              uint32_t* out, cudaStream_t st) {
  const size_t smem = (size_t)(C + 1) * 32 * K * 4;  // staged mask rows
  if (G > 65535 || smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const auto kernel = MODE == WIDE_K2G  ? &grouped_chunk_wide_kernel<K>
                      : MODE == WIDE_K4 ? &grouped_fused_wide_kernel<K>
                                        : &grouped_shift_wide_kernel<K>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long chunks = (B + WIDE_WARPS - 1) / WIDE_WARPS;
  const long long fill =
      (2LL * resident_blocks(kernel, WIDE_WARPS * 32, smem) + G - 1) / G;
  const int gx = (int)(chunks < fill ? chunks : fill);
  kernel<<<dim3(gx, G), WIDE_WARPS * 32, smem, st>>>(
      cls, B, T, follow, mask, G, W, C, live, acc, v0, vout, out);
  return cudaGetLastError();
}

// Whether W state words take the wide shift kernels.
bool shift_wide_words(int W) { return W > 32 && W <= 32 * WIDE_MAX_K; }

template <WideMode MODE>
cudaError_t launch_wide(const int16_t* cls, int B, int T,
                        const uint32_t* follow, const uint32_t* mask, int G,
                        int W, int C, int live, int acc, const uint32_t* v0,
                        uint32_t* vout, uint32_t* out, cudaStream_t st) {
  switch ((W + 31) / 32) {
    case 2: return launch_shift_wide<2, MODE>(cls, B, T, follow, mask, G, W, C, live, acc, v0, vout, out, st);
    case 3: return launch_shift_wide<3, MODE>(cls, B, T, follow, mask, G, W, C, live, acc, v0, vout, out, st);
    case 4: return launch_shift_wide<4, MODE>(cls, B, T, follow, mask, G, W, C, live, acc, v0, vout, out, st);
    case 5: return launch_shift_wide<5, MODE>(cls, B, T, follow, mask, G, W, C, live, acc, v0, vout, out, st);
    default: break;
  }
  return cudaErrorInvalidValue;
}

// K3 past 32 words, K words a lane: a persistent grid of WIDE_WARPS-warp
// blocks over the pair list (its length is on the device), never more
// warps than B * G pairs could fill.
template <int K>
cudaError_t launch_gated_shift(const int16_t* cls, int B, int T,
                               const uint32_t* follow, const uint32_t* mask,
                               int G, int W, int C, int live, int acc,
                               const int* pairs, const int* n_pairs,
                               uint32_t* out, cudaStream_t st) {
  static const int resident =
      resident_blocks(grouped_gated_wide_kernel<K>, WIDE_WARPS * 32, 0);
  const long long need = ((long long)B * G + WIDE_WARPS - 1) / WIDE_WARPS;
  const int blocks = (int)(need < resident ? need : resident);
  grouped_gated_wide_kernel<K><<<blocks, WIDE_WARPS * 32, 0, st>>>(
      cls, B, T, follow, mask, G, W, C, live, acc, pairs, n_pairs, out);
  return cudaGetLastError();
}

cudaError_t launch_gated_shift_wide(const int16_t* cls, int B, int T,
                                    const uint32_t* follow,
                                    const uint32_t* mask, int G, int W, int C,
                                    int live, int acc, const int* pairs,
                                    const int* n_pairs, uint32_t* out,
                                    cudaStream_t st) {
  switch ((W + 31) / 32) {
    case 2: return launch_gated_shift<2>(cls, B, T, follow, mask, G, W, C, live, acc, pairs, n_pairs, out, st);
    case 3: return launch_gated_shift<3>(cls, B, T, follow, mask, G, W, C, live, acc, pairs, n_pairs, out, st);
    case 4: return launch_gated_shift<4>(cls, B, T, follow, mask, G, W, C, live, acc, pairs, n_pairs, out, st);
    case 5: return launch_gated_shift<5>(cls, B, T, follow, mask, G, W, C, live, acc, pairs, n_pairs, out, st);
    default: break;
  }
  return cudaErrorInvalidValue;
}

// Past 160 words: a block's warps (up to WIDE_WARPS, as many as fit
// two W-word buffers each in MAX_SMEM; 0 when one warp's do not) and
// whether its group's tables are staged in shared memory (the constants
// [W] uint4 and C+1 mask rows): where they fit beside WIDE_WARPS warps'
// buffers in a quarter of MAX_SMEM, so that an SM still holds four such
// blocks; else they are read through L1. The kernels are bound by the
// latency of a warp's steps, so warps an SM count for more than staged
// rows (on the H100 the 700-pod set, C = 64, ran 13% slower staged at
// three blocks an SM than read through L1). nfa_kernels raises
// GroupTooWideError before a launch whose plan has no warp.
struct SmemPlan {
  int warps;
  bool staged;
  size_t bytes;
};

SmemPlan smem_plan(int W, int C, bool can_stage) {
  const size_t buf = (size_t)2 * W * 4;
  const size_t tab = (size_t)(C + 5) * W * 4;
  if (can_stage && tab + WIDE_WARPS * buf <= (size_t)MAX_SMEM / 4)
    return {WIDE_WARPS, true, tab + WIDE_WARPS * buf};
  int nw = WIDE_WARPS;
  while (nw > 0 && nw * buf > (size_t)MAX_SMEM) --nw;
  return {nw, false, nw * buf};
}

// K1, K2g or K4 (MODE) past 160 words: blocks of the plan's warps (a
// line each), grid y the groups, grid x as many line chunks as fill the
// card twice over. out is zeroed by the caller.
template <WideMode MODE>
cudaError_t launch_smem(const int16_t* cls, int B, int T,
                        const uint32_t* follow, const uint32_t* mask, int G,
                        int W, int C, int live, int acc, const uint32_t* v0,
                        uint32_t* vout, uint32_t* out, cudaStream_t st) {
  const SmemPlan p = smem_plan(W, C, true);
  if (p.warps == 0 || G > 65535) return cudaErrorInvalidValue;
  const auto kernel =
      MODE == WIDE_K2G
          ? (p.staged ? &grouped_chunk_smem_kernel<true>
                      : &grouped_chunk_smem_kernel<false>)
      : MODE == WIDE_K4 ? (p.staged ? &grouped_fused_smem_kernel<true>
                                    : &grouped_fused_smem_kernel<false>)
                        : (p.staged ? &grouped_shift_smem_kernel<true>
                                    : &grouped_shift_smem_kernel<false>);
  cudaError_t e = allow_smem(kernel, p.bytes);
  if (e != cudaSuccess) return e;
  const long long chunks = (B + p.warps - 1) / p.warps;
  const long long fill =
      (2LL * resident_blocks(kernel, p.warps * 32, p.bytes) + G - 1) / G;
  const int gx = (int)(chunks < fill ? chunks : fill);
  kernel<<<dim3(gx, G), p.warps * 32, p.bytes, st>>>(
      cls, B, T, follow, mask, G, W, C, live, acc, v0, vout, out);
  return cudaGetLastError();
}

// K3 past 160 words: a persistent grid of the plan's warps (buffers
// only: the tables are read through L1) over the pair list, never more
// warps than B * G pairs could fill.
cudaError_t launch_gated_smem(const int16_t* cls, int B, int T,
                              const uint32_t* follow, const uint32_t* mask,
                              int G, int W, int C, int live, int acc,
                              const int* pairs, const int* n_pairs,
                              uint32_t* out, cudaStream_t st) {
  const SmemPlan p = smem_plan(W, C, false);
  if (p.warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(grouped_gated_smem_kernel, p.bytes);
  if (e != cudaSuccess) return e;
  const long long need = ((long long)B * G + p.warps - 1) / p.warps;
  const int resident =
      resident_blocks(grouped_gated_smem_kernel, p.warps * 32, p.bytes);
  const int blocks = (int)(need < resident ? need : resident);
  grouped_gated_smem_kernel<<<blocks, p.warps * 32, p.bytes, st>>>(
      cls, B, T, follow, mask, G, W, C, live, acc, pairs, n_pairs, out);
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
// bit tables, out [B] uint8 (ceil(B / 4) * 4 bytes, 4-byte aligned).
// S/32 is a register width (4, 8, 16 or 32) or above 32: up to 160
// words the wide shift kernel, past them grouped_shift_smem_kernel
// (refused where one warp's two S/32-word buffers exceed a block's
// shared memory); the caller pads a program of another width up to the
// next register width with dead states. The follow buffer holds, after
// its G * S * S/32 words, the shift step's constants [G, S/32, 4] (per
// word: SH, SELF, RL, EX; see ops/nfa_kernels.py shift_constants).
int klogs_grouped_nfa(const int16_t* cls, int B, int T,
                      const uint32_t* follow, const uint32_t* mask, int G,
                      int S, int C, int live, int acc, uint8_t* out,
                      void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (G <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / 32) {
    case 4: return launch_shift<4, true>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 8: return launch_shift<8, true>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 16: return launch_shift<16, true>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 32: return launch_shift<32, true>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    default: break;
  }
  if (S / 32 <= 32) return cudaErrorInvalidValue;
  e = cudaMemsetAsync(out, 0, (size_t)(B + 3) / 4 * 4, st);
  if (e != cudaSuccess) return e;
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  if (shift_wide_words(S / 32))
    return launch_wide<WIDE_K1>(cls, B, T, follow, mask, G, S / 32, C, live,
                                acc, nullptr, nullptr, words, st);
  return launch_smem<WIDE_K1>(cls, B, T, follow, mask, G, S / 32, C, live,
                              acc, nullptr, nullptr, words, st);
}

// K3's pair list: gate [B, GW] words read every `stride` 32-bit words
// (1 for int32 words, 2 for int64 words of 32 bits), bits at or past G
// ignored; counts [(G + 1) * ceil(B / 256) + 1] int32 scratch: the
// per-slab counts, then the pair count, left in its last entry; pairs
// [B * G] int32 gets that many entries, stats [3] int64 the gate's
// counts in tiles of `tile` lines. Three launches: count, scan,
// scatter.
int klogs_gate_pairs(const uint32_t* gate, int B, int GW, int stride, int G,
                     int* counts, int tile, int* pairs, long long* stats,
                     void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (G <= 0 || GW != (G + 31) / 32 || tile <= 0) return cudaErrorInvalidValue;
  const int slabs = (B + PAIR_SLAB - 1) / PAIR_SLAB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gate_pairs_count<<<slabs, PAIR_SLAB, 0, st>>>(gate, B, GW, stride, G,
                                                counts);
  gate_pairs_scan<<<(G + SCAN_WARPS) / SCAN_WARPS, SCAN_WARPS * 32, 0, st>>>(
      counts, G + 1, slabs);
  gate_pairs_scatter<<<slabs, PAIR_SLAB, 0, st>>>(
      gate, B, GW, stride, G, counts, tile, pairs,
      counts + (size_t)(G + 1) * slabs, stats);
  return cudaGetLastError();
}

// K3: cls, follow (with its constants) and S as for klogs_grouped_nfa;
// mask [G, C + 1, S/32] (row C all zero) at every width (from 33 to 160
// words grouped_gated_wide_kernel, past them grouped_gated_smem_kernel);
// pairs and n_pairs from
// klogs_gate_pairs (on the device); out ceil(B / 4) uint32 words,
// zeroed here, whose byte b is set to 1 for each matching line b.
int klogs_grouped_nfa_gated(const int16_t* cls, int B, int T,
                            const uint32_t* follow, const uint32_t* mask,
                            int G, int S, int C, int live, int acc,
                            const int* pairs, const int* n_pairs,
                            uint32_t* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (G <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(out, 0, (size_t)(B + 3) / 4 * 4, st);
  if (e != cudaSuccess) return e;
  switch (S / 32) {
    case 4: return launch_gated<4>(cls, B, T, follow, mask, G, C, live, acc, pairs, n_pairs, out, st);
    case 8: return launch_gated<8>(cls, B, T, follow, mask, G, C, live, acc, pairs, n_pairs, out, st);
    case 16: return launch_gated<16>(cls, B, T, follow, mask, G, C, live, acc, pairs, n_pairs, out, st);
    case 32: return launch_gated<32>(cls, B, T, follow, mask, G, C, live, acc, pairs, n_pairs, out, st);
    default: break;
  }
  if (S / 32 <= 32) return cudaErrorInvalidValue;
  if (shift_wide_words(S / 32))
    return launch_gated_shift_wide(cls, B, T, follow, mask, G, S / 32, C,
                                   live, acc, pairs, n_pairs, out, st);
  return launch_gated_smem(cls, B, T, follow, mask, G, S / 32, C, live, acc,
                           pairs, n_pairs, out, st);
}

// K4: as klogs_grouped_nfa (the same follow buffer; from 33 to 160
// words grouped_fused_wide_kernel, past them grouped_fused_smem_kernel),
// with out [B] uint32 words that the caller zeroed (a word is set to 1
// for each matching line).
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
    case 4: return launch_shift<4, false>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 8: return launch_shift<8, false>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 16: return launch_shift<16, false>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    case 32: return launch_shift<32, false>(cls, B, T, follow, mask, G, C, live, acc, out, st);
    default: break;
  }
  if (S / 32 <= 32) return cudaErrorInvalidValue;
  if (shift_wide_words(S / 32))
    return launch_wide<WIDE_K4>(cls, B, T, follow, mask, G, S / 32, C, live,
                                acc, nullptr, nullptr, out, st);
  return launch_smem<WIDE_K4>(cls, B, T, follow, mask, G, S / 32, C, live,
                              acc, nullptr, nullptr, out, st);
}

// K2g: cls, follow (with its constants) and mask as for
// klogs_grouped_nfa_gated ([G, C + 1, S/32]); S/32 a register width (4,
// 8, 16, 32), 33 to 160 words (the wide shift kernel) or past them
// (grouped_chunk_smem_kernel); v0 and vout
// [B, G, S/32] words, the carry of each (line, group); out ceil(B / 4)
// uint32 words, zeroed here, whose byte b is set to 1 where some group
// of line b holds acc.
int klogs_grouped_chunk_nfa(const int16_t* cls, int B, int T,
                            const uint32_t* follow, const uint32_t* mask,
                            int G, int S, int C, int live, int acc,
                            const uint32_t* v0, uint32_t* vout,
                            uint32_t* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (G <= 0 || G > 65535 * GCHUNK_THREADS) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(out, 0, (size_t)(B + 3) / 4 * 4, st);
  if (e != cudaSuccess) return e;
  switch (S / 32) {
    case 4: return launch_grouped_chunk<4>(cls, B, T, follow, mask, G, C, live, acc, v0, vout, out, st);
    case 8: return launch_grouped_chunk<8>(cls, B, T, follow, mask, G, C, live, acc, v0, vout, out, st);
    case 16: return launch_grouped_chunk<16>(cls, B, T, follow, mask, G, C, live, acc, v0, vout, out, st);
    case 32: return launch_grouped_chunk<32>(cls, B, T, follow, mask, G, C, live, acc, v0, vout, out, st);
    default: break;
  }
  if (S / 32 <= 32) return cudaErrorInvalidValue;
  if (shift_wide_words(S / 32))
    return launch_wide<WIDE_K2G>(cls, B, T, follow, mask, G, S / 32, C, live,
                                 acc, v0, vout, out, st);
  return launch_smem<WIDE_K2G>(cls, B, T, follow, mask, G, S / 32, C, live,
                               acc, v0, vout, out, st);
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
