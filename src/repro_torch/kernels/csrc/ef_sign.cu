// Hopper (sm_90a) kernels of the bucketed EF-signSGD exchange.
//
// Three kernels carry one ef_allgather step over a (nb, bs) fp32 bucket
// stack, bs % 32 == 0:
//
//   ef_bucket_stats            per bucket  sum|g+e|  and  sum (g+e)^2
//   ef_bucket_sign_compress    packed sign words of p = g+e and the residual
//   ef_bucket_decompress_mean  mean over W payloads of scale * sign
//
// Each is a plain C entry point taking raw device pointers, the sizes and the
// caller's stream; it launches, does not synchronise, allocates nothing and
// returns cudaGetLastError(). Sign words are stored as 32-bit words: bit i of
// word j is (p[32j+i] >= 0), LSB first, so -0.0 packs as 1 and NaN as 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and never --use_fast_math: the parity contract rests on IEEE arithmetic
// and on denormals surviving (no flush to zero).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block in every kernel

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Replaces kernels/ef_sign.py::bucket_stats (Pallas, one grid step per bucket).
// Bound on the H100: memory. It reads g and e once (8 B per element) and
// writes two floats per bucket; the ~5 flops per element are far below the
// card's fp32 rate. Design: one block per bucket (nb = 18,858 at full width
// fills the 132 SMs many times over), 16-byte float4 loads so each warp reads
// 512 contiguous bytes per instruction, fp32 partial sums in registers, then
// a warp-shuffle and a shared-memory reduction. The sum order differs from
// XLA's, so the result matches the plain version to a tolerance, not bitwise.
__global__ void __launch_bounds__(kThreads)
bucket_stats_kernel(const float* __restrict__ g, const float* __restrict__ e,
                    float* __restrict__ l1, float* __restrict__ l2sq, long long bs) {
  const long long b = blockIdx.x;
  const float4* g4 = reinterpret_cast<const float4*>(g + b * bs);
  const float4* e4 = reinterpret_cast<const float4*>(e + b * bs);
  const long long n4 = bs / 4;
  float s1 = 0.f, s2 = 0.f;
  for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 x = g4[i];
    const float4 y = e4[i];
    const float p0 = x.x + y.x, p1 = x.y + y.y, p2 = x.z + y.z, p3 = x.w + y.w;
    s1 += fabsf(p0) + fabsf(p1) + fabsf(p2) + fabsf(p3);
    s2 += p0 * p0 + p1 * p1 + p2 * p2 + p3 * p3;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  __shared__ float sh1[kThreads / 32], sh2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh1[warp] = s1;
    sh2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    s1 = warp_sum(lane < n_warps ? sh1[lane] : 0.f);
    s2 = warp_sum(lane < n_warps ? sh2[lane] : 0.f);
    if (lane == 0) {
      l1[b] = s1;
      l2sq[b] = s2;
    }
  }
}

// Replaces kernels/ef_sign.py::bucket_ef_sign_compress (Pallas: a shift-and-
// sum bit pack over a VMEM-resident bucket). Bound on the H100: memory, 12.125
// B per element (read g and e, write e' and 1/8 B of words). Design: one block
// per bucket, the bucket's scale read once per block; lane i of a warp holds
// element 32j+i, so __ballot_sync(p >= 0) IS word j, LSB first, with no
// shifting or reduction, and lane 0 stores it. Every load and store of a warp
// is one contiguous 128-byte line. e' = p - (bit ? s : -s) is the same IEEE
// operation as the reference's p - s*(2*bit-1), so words and residual are
// bitwise equal to the plain version given the same scales.
__global__ void __launch_bounds__(kThreads)
bucket_ef_sign_compress_kernel(const float* __restrict__ g, const float* __restrict__ e,
                               const float* __restrict__ scales, uint32_t* __restrict__ words,
                               float* __restrict__ e_new, long long bs) {
  const long long b = blockIdx.x;
  const float s = scales[b];
  const long long m = bs / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (long long j = warp; j < m; j += n_warps) {
    const long long idx = b * bs + j * 32 + lane;
    const float p = g[idx] + e[idx];
    const bool bit = p >= 0.f;  // false for NaN, true for -0.0
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    e_new[idx] = p - (bit ? s : -s);
    if (lane == 0) words[b * m + j] = word;
  }
}

// Replaces kernels/ef_sign.py::bucket_sign_decompress_mean (Pallas: a static
// unroll over the W senders). Bound on the H100: memory, W/8 + 4 B per
// element (the W payloads' bits read once, the fp32 mean written once).
// Design: one block per bucket, one thread per output element in a block-
// stride loop; the 32 lanes of a warp share one word per sender, so each word
// is one broadcast load and every store is a contiguous 128-byte line. W is a
// runtime loop bound with no unroll cap. The accumulation order is the
// reference's: acc = 0, acc += scale_i * (+-1) for i = 0..W-1 in order, then
// the mean. XLA rewrites the division by the constant W into a multiplication
// by its fp32 reciprocal; the caller passes that reciprocal (inv_w = 1.0f/W,
// rounded once), so the result is bitwise the reference's for every W.
// scale * (+-1) is exact, so contracting it with the add into an FMA changes
// nothing.
__global__ void __launch_bounds__(kThreads)
bucket_decompress_mean_kernel(const uint32_t* __restrict__ words, const float* __restrict__ scales,
                              float* __restrict__ out, long long w, long long nb, long long bs,
                              float inv_w) {
  const long long b = blockIdx.x;
  const long long m = bs / 32;
  const long long sender_words = nb * m;
  for (long long i = threadIdx.x; i < bs; i += blockDim.x) {
    const long long wi = b * m + (i >> 5);
    const uint32_t bit = static_cast<uint32_t>(i & 31);
    float acc = 0.f;
    for (long long k = 0; k < w; ++k) {
      const uint32_t wd = words[k * sender_words + wi];
      const float s = scales[k * nb + b];
      acc = acc + s * (((wd >> bit) & 1u) ? 1.f : -1.f);
    }
    out[b * bs + i] = acc * inv_w;
  }
}

}  // namespace

extern "C" {

int ef_bucket_stats(const float* g, const float* e, float* l1, float* l2sq, long long nb,
                    long long bs, cudaStream_t stream) {
  if (nb > 0) bucket_stats_kernel<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(g, e, l1, l2sq, bs);
  return static_cast<int>(cudaGetLastError());
}

int ef_bucket_sign_compress(const float* g, const float* e, const float* scales, uint32_t* words,
                            float* e_new, long long nb, long long bs, cudaStream_t stream) {
  if (nb > 0)
    bucket_ef_sign_compress_kernel<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(
        g, e, scales, words, e_new, bs);
  return static_cast<int>(cudaGetLastError());
}

int ef_bucket_decompress_mean(const uint32_t* words, const float* scales, float* out, long long w,
                              long long nb, long long bs, float inv_w, cudaStream_t stream) {
  if (nb > 0)
    bucket_decompress_mean_kernel<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(
        words, scales, out, w, nb, bs, inv_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
