// Ragged row pack for Hopper (sm_90a), bound to Python with ctypes.
//
// A framed batch is one contiguous payload of line bytes plus per-line
// starts and lengths. The kernels of nfa_kernels.cu read lines as
// zero-padded rows of one width, so the engine cuts the payload into
// rows:
//
//     out[r, j] = payload[starts[r] + skip + j]   for j < clamp(lens[r] - skip, 0, width)
//     out[r, j] = 0                               otherwise, and for every r >= n
//
// skip = 0 gives a width bucket's rows; skip = k * chunk_bytes gives
// chunk k of the long lines. This replaces no Pallas kernel: it is the
// device counterpart of the JAX engine's host packer
// (klogs_tpu/native/_hostops.c pack_classify_framed, whose rows the JAX
// engine classifies on the host), so that the payload crosses to the
// card once per batch and is scattered there.
//
// What bounds it on an H100: bytes. It reads each kept byte once and
// writes rows * width bytes, a few tens of MB a batch against 3.35
// TB/s, and does no arithmetic to speak of. The schedule is a warp per
// row: each lane writes 4-byte words of the row, so a warp's store
// covers 128 contiguous bytes, and gathers them with byte loads from
// the row's unaligned start (a warp's loads at one byte offset span 128
// contiguous bytes, served by L1 after the first). Rows shorter than
// the width write zeros without reading. Rows are strided over a grid
// of at most MAX_BLOCKS blocks.

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

}  // extern "C"
