// Ragged row pack and the fused pack-strip-classify, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// A framed batch is one contiguous payload of line bytes plus per-line
// starts and lengths. The kernels of nfa_kernels.cu read lines as rows
// of int16 class ids, and the literal sweep as zero-padded byte rows.
// Neither kernel here replaces a Pallas kernel: they are the device
// counterpart of the JAX engine's host packer
// (klogs_tpu/native/_hostops.c pack_classify_framed), so that the
// payload crosses to the card once per batch and is cut there.
//
// pack_rows_kernel cuts byte rows:
//
//     out[r, j] = payload[starts[r] + skip + j]   for j < clamp(lens[r] - skip, 0, width)
//     out[r, j] = 0                               otherwise, and for every r >= n
//
// It serves callers that want bytes only (the indexed engine's device
// sweep). Its schedule is a warp per row: each lane writes 4-byte words
// of the row and gathers them with byte loads from the row's unaligned
// start. Rows are strided over a grid of at most MAX_BLOCKS blocks.
//
// pack_classify_kernel is pack_classify_framed on the card, and the
// long-line chunks' classifier besides. For each row r:
//
//     len[r]  = raw_lens[r] less its trailing run of '\n'   (0 for r >= n)
//     rem     = len[r] - skip
//     cls[r]  = [BEGIN if first] body [latch PAD if final], T = width + first + 2*final
//     body[j] = byte_class[payload[starts[r] + skip + j]]   for j < min(rem, width)
//             = END                                        for j == rem, j < width + final
//             = PAD                                        otherwise
//
// (ops/nfa.py classify_chunk after pack_rows, with the strip of the
// host packer). It also writes len[r] and, when asked, the byte rows
// of pack_rows with the stripped lengths (the sweep's input).
//
// What bounds both on an H100: bytes. The fused kernel reads each kept
// byte once and writes 2 * T bytes a row of class ids (plus 8 of
// length), no arithmetic to speak of. Its schedule
// (pack_classify_kernel):
//
// - A block of 128 threads owns a run of R consecutive rows, R a
//   multiple of 8 (about 4096 class ids), so its class ids are one
//   contiguous span that starts 16-byte aligned even though rows of T
//   int16 are not.
// - Each row's stripped end is found by scanning back from the raw end
//   (almost always one byte), a thread a row.
// - Every 16-byte aligned word that holds a kept byte of a row's window
//   is copied into shared memory with cp.async, all of the run's words
//   issued before any is waited on: a thread that loads its vectors'
//   bytes itself, one vector at a time, leaves the card waiting on
//   memory (chip_smoke.py's pack phase times that flat schedule beside
//   this one). Each aligned word holds a byte of the line, so it never
//   leaves the line's page.
// - A warp a row then composes the row's class ids into shared memory
//   (byte_class lives there too): BEGIN, the kept bytes' classes, END,
//   PAD; and the span goes out with 16-byte stores, a warp writing 512
//   contiguous bytes. The byte rows, when asked for, go out from the
//   staged bytes the same way.
// - Rows past n, and a line's tail past END, are PAD written without
//   any read.
//
// Rows wider than STAGED_WIDTH (the long lines' 4096-byte chunks) take
// pack_classify_flat instead: a block of 8 such rows is too few to hide
// its phases behind other blocks, and the flat schedule was the faster
// one there (chip_smoke.py's pack phase times both): a thread composes 8
// class ids of the flat span at a time from two aligned 8-byte loads
// funnelled into place, and writes them with one 16-byte store.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // rows per block at a time
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(WARPS * 32)
pack_rows_kernel(const uint8_t* __restrict__ payload,
                 const int64_t* __restrict__ starts,
                 const int64_t* __restrict__ lens, int n, int width,
                 int rows, long long skip, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       r < rows; r += stride) {
    long long len = 0;
    const uint8_t* src = payload;
    if (r < n) {
      len = lens[r] - skip;
      len = len < 0 ? 0 : (len > width ? width : len);
      if (len > 0) src = payload + starts[r] + skip;
    }
    uint8_t* dst = out + r * width;
    if ((width & 3) == 0) {
      uint32_t* dst4 = reinterpret_cast<uint32_t*>(dst);
      for (int w = lane; w < (width >> 2); w += 32) {
        const int j = w << 2;
        uint32_t word = 0;
        if (j + 4 <= len) {
          word = (uint32_t)__ldg(src + j) | (uint32_t)__ldg(src + j + 1) << 8
                 | (uint32_t)__ldg(src + j + 2) << 16
                 | (uint32_t)__ldg(src + j + 3) << 24;
        } else {
          for (int b = 0; b < 4 && j + b < len; ++b)
            word |= (uint32_t)__ldg(src + j + b) << (8 * b);
        }
        dst4[w] = word;
      }
    } else {
      for (int j = lane; j < width; j += 32) dst[j] = j < len ? __ldg(src + j) : 0;
    }
  }
}

constexpr int CLS_THREADS = 256;
constexpr int CLS_MAX_ROWS = 256;  // rows a block owns at most

// The 8 bytes at p, every one of them inside the line: the aligned
// 8-byte words that hold them, funnelled into place.
__device__ __forceinline__ uint64_t load8(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(a & ~uintptr_t(7));
  const unsigned sh = (unsigned)(a & 7) * 8;
  const uint64_t lo = __ldg(w);
  if (sh == 0) return lo;
  return (lo >> sh) | (__ldg(w + 1) << (64 - sh));
}

struct Classes {
  const int16_t* tab;  // byte_class, in shared memory
  int off, width, window;  // first, L, L + final
  int16_t begin, end, pad;

  // Column c of a row whose bytes start at src and whose remaining
  // length is rem (clamped to [-1, width + 2]).
  __device__ __forceinline__ int16_t at(const uint8_t* src, int rem,
                                        int c) const {
    if (c < off) return begin;
    const int j = c - off;
    if (j < width && j < rem) return tab[__ldg(src + j)];
    return (j == rem && j < window) ? end : pad;
  }
};

__device__ __forceinline__ uint32_t pair(int16_t a, int16_t b) {
  return (uint32_t)(uint16_t)a | (uint32_t)(uint16_t)b << 16;
}

__global__ void __launch_bounds__(CLS_THREADS)
pack_classify_flat(const uint8_t* __restrict__ payload,
                   const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ raw_lens, int n, int width,
                   int rows, int run, long long skip, int first, int final_,
                   const int32_t* __restrict__ byte_class, int begin_c,
                   int end_c, int pad_c, int16_t* __restrict__ cls,
                   int64_t* __restrict__ lens_out,
                   uint8_t* __restrict__ bytes_out) {
  __shared__ int16_t s_tab[256];
  __shared__ long long s_src[CLS_MAX_ROWS];  // start + skip
  __shared__ int s_rem[CLS_MAX_ROWS];        // len - skip, clamped
  const int T = width + first + 2 * final_;
  const long long r0 = (long long)blockIdx.x * run;
  const int nr = (int)min((long long)run, (long long)rows - r0);
  for (int i = threadIdx.x; i < 256; i += CLS_THREADS)
    s_tab[i] = (int16_t)byte_class[i];
  for (int i = threadIdx.x; i < nr; i += CLS_THREADS) {
    const long long r = r0 + i;
    long long start = 0, len = 0;
    if (r < n) {
      start = starts[r];
      len = raw_lens[r];
      const uint8_t* line = payload + start;
      while (len > 0 && __ldg(line + len - 1) == '\n') --len;
    }
    lens_out[r] = len;
    long long rem = len - skip;
    rem = rem < -1 ? -1 : (rem > width + 2 ? width + 2 : rem);
    s_src[i] = start + skip;
    s_rem[i] = (int)rem;
  }
  __syncthreads();

  const Classes k{s_tab, first, width, width + final_, (int16_t)begin_c,
                  (int16_t)end_c, (int16_t)pad_c};
  int16_t* out = cls + r0 * T;
  const int n_el = nr * T;
  for (int v = threadIdx.x; v < (n_el >> 3); v += CLS_THREADS) {
    const int e = v << 3;
    const int i = e / T;
    const int c = e - i * T;
    int16_t x[8];
    if (c + 8 <= T) {
      const int rem = s_rem[i];
      const uint8_t* src = payload + s_src[i];
      const int j = c - first;
      if (j >= 0 && j + 8 <= min(rem, width)) {
        const uint64_t w = load8(src + j);
#pragma unroll
        for (int t = 0; t < 8; ++t) x[t] = s_tab[(w >> (8 * t)) & 0xff];
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) x[t] = k.at(src, rem, c + t);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int ii = (e + t) / T;
        x[t] = k.at(payload + s_src[ii], s_rem[ii], e + t - ii * T);
      }
    }
    reinterpret_cast<uint4*>(out)[v] =
        make_uint4(pair(x[0], x[1]), pair(x[2], x[3]), pair(x[4], x[5]),
                   pair(x[6], x[7]));
  }
  // The ragged tail of a last run whose rows * T is not a multiple of 8.
  for (int e = (n_el & ~7) + threadIdx.x; e < n_el; e += CLS_THREADS) {
    const int i = e / T;
    out[e] = k.at(payload + s_src[i], s_rem[i], e - i * T);
  }

  if (bytes_out == nullptr) return;
  uint8_t* bout = bytes_out + r0 * width;
  const int n_b = nr * width;
  if ((width & 15) == 0) {
    for (int v = threadIdx.x; v < (n_b >> 4); v += CLS_THREADS) {
      const int e = v << 4;
      const int i = e / width;
      const int c = e - i * width;
      const int kept = max(0, min(s_rem[i], width));
      const uint8_t* src = payload + s_src[i];
      uint64_t w0 = 0, w1 = 0;
      if (c + 16 <= kept) {
        w0 = load8(src + c);
        w1 = load8(src + c + 8);
      } else {
        for (int t = 0; t < 8 && c + t < kept; ++t)
          w0 |= (uint64_t)__ldg(src + c + t) << (8 * t);
        for (int t = 0; t < 8 && c + 8 + t < kept; ++t)
          w1 |= (uint64_t)__ldg(src + c + 8 + t) << (8 * t);
      }
      reinterpret_cast<uint4*>(bout)[v] =
          make_uint4((uint32_t)w0, (uint32_t)(w0 >> 32), (uint32_t)w1,
                     (uint32_t)(w1 >> 32));
    }
  } else {
    for (int e = threadIdx.x; e < n_b; e += CLS_THREADS) {
      const int i = e / width;
      const int c = e - i * width;
      bout[e] = c < s_rem[i] ? __ldg(payload + s_src[i] + c) : 0;
    }
  }
}

// The rows a block owns: a multiple of 8 (so that each block's span of
// class ids starts 16-byte aligned), about 8192 class ids a block.
int classify_run(int T) {
  const int run = 8 * (1024 / T > 1 ? 1024 / T : 1);
  return run > CLS_MAX_ROWS ? CLS_MAX_ROWS : run;
}

constexpr int STAGED_THREADS = 128;
// The widest rows that are staged; a block's shared memory then stays
// under the 48 KiB that needs no opt-in.
constexpr int STAGED_WIDTH = 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Shared memory of a staged block: the run's class ids (16-byte
// aligned, R * T int16), the staged words (R * cpr * 16 bytes), then
// each row's source offset and remaining length.
struct Staged {
  int T, cpr, run;
  __host__ __device__ Staged(int width, int T_, int run_)
      : T(T_), cpr((width + 15) / 16 + 1), run(run_) {}
  __host__ __device__ size_t words() const {
    return (size_t)run * T * 2;
  }
  __host__ __device__ size_t src() const {
    return words() + (size_t)run * cpr * 16;
  }
  __host__ __device__ size_t bytes() const {
    return src() + (size_t)run * (8 + 4);
  }
};

// Row i's window in the stage: its first aligned word, from the byte
// where the window starts.
__device__ __forceinline__ const uint8_t* staged_row(const uint8_t* stage,
                                                     int cpr, int i,
                                                     const uint8_t* src) {
  return stage + (size_t)i * cpr * 16
         + (reinterpret_cast<uintptr_t>(src) & 15);
}

__global__ void __launch_bounds__(STAGED_THREADS)
pack_classify_kernel(const uint8_t* __restrict__ payload,
                     const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ raw_lens, int n, int width,
                     int rows, int run, long long skip, int first, int final_,
                     const int32_t* __restrict__ byte_class, int begin_c,
                     int end_c, int pad_c, int16_t* __restrict__ cls,
                     int64_t* __restrict__ lens_out,
                     uint8_t* __restrict__ bytes_out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int16_t s_tab[256];
  const int T = width + first + 2 * final_;
  const Staged lay(width, T, run);
  const int cpr = lay.cpr;
  int16_t* s_out = reinterpret_cast<int16_t*>(dyn);
  uint8_t* stage = dyn + lay.words();
  long long* s_src = reinterpret_cast<long long*>(dyn + lay.src());
  int* s_rem = reinterpret_cast<int*>(s_src + run);
  const long long r0 = (long long)blockIdx.x * run;
  const int nr = (int)min((long long)run, (long long)rows - r0);
  for (int i = threadIdx.x; i < 256; i += STAGED_THREADS)
    s_tab[i] = (int16_t)byte_class[i];
  for (int i = threadIdx.x; i < nr; i += STAGED_THREADS) {
    const long long r = r0 + i;
    long long start = 0, len = 0;
    if (r < n) {
      start = starts[r];
      len = raw_lens[r];
      const uint8_t* line = payload + start;
      while (len > 0 && __ldg(line + len - 1) == '\n') --len;
    }
    lens_out[r] = len;
    long long rem = len - skip;
    rem = rem < -1 ? -1 : (rem > width + 2 ? width + 2 : rem);
    s_src[i] = start + skip;
    s_rem[i] = (int)rem;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nr * cpr; q += STAGED_THREADS) {
    const int i = q / cpr;
    const int kept = min(s_rem[i], width);
    if (kept <= 0) continue;
    const uintptr_t src = reinterpret_cast<uintptr_t>(payload + s_src[i]);
    const uintptr_t a = (src & ~uintptr_t(15)) + 16 * (uintptr_t)(q - i * cpr);
    if (a < src + kept)
      cp_async16(stage + (size_t)q * 16, reinterpret_cast<const void*>(a));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int cols = width + 2 * final_, window = width + final_;
  const int16_t end = (int16_t)end_c, pad = (int16_t)pad_c;
  for (int i = threadIdx.x >> 5; i < nr; i += STAGED_THREADS / 32) {
    const int rem = s_rem[i];
    const int kept = max(0, min(rem, width));
    const uint8_t* at = staged_row(stage, cpr, i, payload + s_src[i]);
    int16_t* row = s_out + i * T + first;
    if (first && lane == 0) row[-1] = (int16_t)begin_c;
    for (int j = lane; j < cols; j += 32)
      row[j] = j < kept ? s_tab[at[j]]
                        : ((j == rem && j < window) ? end : pad);
  }
  __syncthreads();
  int16_t* out = cls + r0 * T;
  const int n_el = nr * T;
  const uint4* s4 = reinterpret_cast<const uint4*>(s_out);
  for (int v = threadIdx.x; v < (n_el >> 3); v += STAGED_THREADS)
    reinterpret_cast<uint4*>(out)[v] = s4[v];
  for (int e = (n_el & ~7) + threadIdx.x; e < n_el; e += STAGED_THREADS)
    out[e] = s_out[e];

  if (bytes_out == nullptr) return;
  uint8_t* bout = bytes_out + r0 * width;
  if ((width & 15) == 0) {
    const int per_row = width >> 4;
    for (int v = threadIdx.x; v < nr * per_row; v += STAGED_THREADS) {
      const int i = v / per_row;
      const int c = (v - i * per_row) << 4;
      const int kept = max(0, min(s_rem[i], width));
      const uint8_t* at = staged_row(stage, cpr, i, payload + s_src[i]);
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if (c + t < kept) w[t >> 2] |= (uint32_t)at[c + t] << (8 * (t & 3));
      reinterpret_cast<uint4*>(bout)[v] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int e = threadIdx.x; e < nr * width; e += STAGED_THREADS) {
      const int i = e / width;
      const int c = e - i * width;
      const uint8_t* at = staged_row(stage, cpr, i, payload + s_src[i]);
      bout[e] = c < max(0, min(s_rem[i], width)) ? at[c] : 0;
    }
  }
}

// The rows a staged block owns: a multiple of 8 (so that each block's
// span of class ids starts 16-byte aligned), about 4096 class ids.
int staged_run(int T) {
  const int k = (4096 + 4 * T) / (8 * T);
  const int run = 8 * (k > 1 ? k : 1);
  return run > CLS_MAX_ROWS ? CLS_MAX_ROWS : run;
}


}  // namespace

extern "C" {

const char* klogs_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// payload [*] uint8, starts and lens [n] int64, out [rows, width] uint8
// (row-major, its rows 4-byte aligned when width is a multiple of 4),
// n <= rows.
int klogs_pack_rows(const uint8_t* payload, const int64_t* starts,
                    const int64_t* lens, int n, int width, int rows,
                    long long skip, uint8_t* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (rows <= 0) return cudaSuccess;
  if (width <= 0 || n < 0 || n > rows || skip < 0) return cudaErrorInvalidValue;
  long long blocks = ((long long)rows + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  pack_rows_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      payload, starts, lens, n, width, rows, skip, out);
  return cudaGetLastError();
}

// payload [*] uint8, starts and raw_lens [n] int64, byte_class [256]
// int32; out: cls [rows, width + first + 2 * final] int16, lens_out
// [rows] int64 (the stripped lengths, 0 past n), bytes_out [rows, width]
// uint8 or null; cls and bytes_out 16-byte aligned, n <= rows, first and
// final 0 or 1. flat 1 takes the flat schedule whatever the width (for
// timing the two side by side); 0 stages rows up to STAGED_WIDTH.
int klogs_pack_classify_rows(const uint8_t* payload, const int64_t* starts,
                             const int64_t* raw_lens, int n, int width,
                             int rows, long long skip, int first, int final_,
                             const int32_t* byte_class, int begin_c,
                             int end_c, int pad_c, int16_t* cls,
                             int64_t* lens_out, uint8_t* bytes_out,
                             int flat, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (rows <= 0) return cudaSuccess;
  if (width <= 0 || n < 0 || n > rows || skip < 0 || (first | final_) > 1
      || first < 0 || final_ < 0 || width > (1 << 26)
      || (reinterpret_cast<uintptr_t>(cls) & 15)
      || (reinterpret_cast<uintptr_t>(bytes_out) & 15))
    return cudaErrorInvalidValue;
  const int T = width + first + 2 * final_;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!flat && width <= STAGED_WIDTH) {
    const int run = staged_run(T);
    const size_t smem = Staged(width, T, run).bytes();
    const long long blocks = ((long long)rows + run - 1) / run;
    pack_classify_kernel<<<(unsigned)blocks, STAGED_THREADS, smem, st>>>(
        payload, starts, raw_lens, n, width, rows, run, skip, first, final_,
        byte_class, begin_c, end_c, pad_c, cls, lens_out, bytes_out);
  } else {
    const int frun = classify_run(T);
    const long long blocks = ((long long)rows + frun - 1) / frun;
    pack_classify_flat<<<(unsigned)blocks, CLS_THREADS, 0, st>>>(
        payload, starts, raw_lens, n, width, rows, frun, skip, first, final_,
        byte_class, begin_c, end_c, pad_c, cls, lens_out, bytes_out);
  }
  return cudaGetLastError();
}

}  // extern "C"
