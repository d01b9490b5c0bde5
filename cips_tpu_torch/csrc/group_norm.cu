// Fused GroupNorm and InstanceNorm, with the activation that follows the norm (none, SiLU or
// LeakyReLU 0.2), forward and backward, for Hopper (sm_90a), bound to PyTorch through ctypes
// (cips_tpu_torch/ops/group_norm.py).
//
// Replaces no TPU kernel. The JAX package leaves GroupNorm to XLA, which fuses the statistics,
// the affine and the activation into a few passes over the activation. PyTorch runs the same
// arithmetic eagerly as about a dozen elementwise and reduction kernels a norm: an fp32 copy of
// the activation, its square, two reductions, two broadcast passes for the affine and one for
// the activation, and a dozen fp32 full-size passes in autograd's backward, which also keeps
// the fp32 copy and the activation's input alive until then. These kernels were added to cut
// that traffic and that memory: the backward keeps x and the per-group mean and 1/std alone.
//
// The function. x is (N, C, S) (S the product of the spatial sizes), bf16 or fp32, laid out
// as rows (NCDHW: each (n, c) a contiguous row of S) or channels last (NDHWC: each position's C
// channels contiguous, as the models' activations are, their input being a channels-last
// volume); y and dx take x's layout. G groups of C/G consecutive channels (C/G = 1:
// InstanceNorm). Per (n, g), over its C/G * S
// elements and, over a space group, those of every rank (the sums all-reduced between the
// launches):
//   mean = E[x], inv = rsqrt(max(E[x^2] - mean^2, 0) + eps)   fp32 sums, fixed order
// per (n, c), in fp32 and rounded to x's dtype (rnd):
//   scale = rnd(inv * w[c]),  offset = rnd(b[c] - (mean * inv) * w[c])
// per element:
//   z = rnd(rnd(x * scale) + offset),  y = rnd(act(z)), act in fp32
// which are the plain version's rounding points, so the forward equals it up to the order of
// the fp32 sums. The backward is the derivative of that graph (a rounding's derivative taken
// as 1, as autograd takes it), with dz = dy * act'(z) in fp32 and z recomputed from x:
//   A[n,c] = sum dz,  B[n,c] = sum dz * (x - mean)                (per channel; over the group)
//   dx = dz * scale - inv^3 [var >= 0] (x - mean) sum_c w B / M - inv sum_c w A / M
//   dw[c] = sum_n inv B[n,c],  db[c] = sum_n A[n,c]               (this rank's sums)
// rounded once to x's dtype; M the group's element count.
//
// Launches. Forward: moments_partial (fp32 sum x and sum x^2 of each channel over a block's
// chunk: a fixed slice of a row's S elements, or of a sample's S positions), moments_group (each
// group's partials in a fixed order: no atomics, so a step repeats bit for bit), then apply.
// Backward: bwd_partial (sum dz and sum dz (x - mean) of each channel over a chunk),
// bwd_channel (each channel's sums over its chunks, then dw and db over n in order), then
// bwd_dx. Over a space group the caller all-reduces moments_group's sums and bwd_channel's A
// and B between the launches. The channels-last kernels (cl_*) give each thread 16 bytes of
// channels at a position and a lane of the block's positions; a block's channel sums add the
// lanes in a fixed order in shared memory.
//
// What bounds it on an H100 SXM: bytes. Reading x and writing y once is 4 B an element in bf16,
// the backward's x and dy read once and dx written once 6 B; at 3.35 TB/s the causal
// generator's ~4e9 normalised elements a step need ~5 and ~7 ms. The kernels read x twice in
// the forward (the moments, then the apply) and x and dy twice in the backward: 6 and 10 B an
// element. The design serves bandwidth: 16-byte loads and stores (8 bf16 or 4 fp32 values a
// thread, 4 loads in flight) wherever the layout allows (rows: S a multiple of the vector;
// channels last: C a multiple of it, C / vector dividing the block's 256 threads, C <= 512), and enough
// blocks (a chunk each, sized by the wrapper for its shape) to fill 132 SMs from the causal
// encoder's 4.7 M-element groups down to the discriminators' 2,304-element rows. The per-block
// statistics and coefficients are a few fp32 operations a block, the sums a tree (fp32, or
// fp64 within a block for fp32 data).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // 16-byte loads a thread has in flight, over its K input tensors
constexpr float kLeakySlope = 0.2f;
constexpr int kMaxClChannels = 512;  // channels last: the per-channel tables in shared memory

enum Act : int { kNone = 0, kSilu = 1, kLeaky = 2 };
// rows element by element, rows in 16-byte vectors, channels last in 16-byte vectors
enum Mode : int { kRows = 0, kRowsVec = 1, kChannelsLast = 2 };

// A thread's and a block's sums: fp32 for bf16 data, whose rounding is 2^-9; fp64 for fp32
// data, so that the sums over a chunk (up to 256 terms a thread) round no more than PyTorch's
// fp32 reductions of the plain version do. A block's sum is stored as fp32.
template <typename T>
using Acc = std::conditional_t<sizeof(T) == 4, double, float>;

// --- element access: V values at a time (V = 1, or 16 bytes' worth), widened to fp32 ---------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = widen(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "fp32 vectors are 4 wide");
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x, out[1] = r.y, out[2] = r.z, out[3] = r.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) out[2 * i] = bf16_lo(w[i]), out[2 * i + 1] = bf16_hi(w[i]);
  }
}

// Stores V values already rounded to T (rnd), so the conversion is exact.
template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&in)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) p[0] = in[0];
    else p[0] = __float2bfloat16_rn(in[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bf16_bits(in[2 * i]) | (bf16_bits(in[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// --- the activation and its derivative, as PyTorch's CUDA kernels compute them in fp32 -------

template <int A>
__device__ __forceinline__ float act(float z) {
  if constexpr (A == kSilu) return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
  else if constexpr (A == kLeaky) return z > 0.0f ? z : __fmul_rn(z, kLeakySlope);
  else return z;
}

// The backward's sigmoid takes the special-function unit's exp2 and reciprocal (a few ulp in
// fp32, far under bf16's rounding and under fp32 sums' reordering) in place of expf and an
// IEEE division, which cost about 20 instructions an element in each of two kernels.
template <int A>
__device__ __forceinline__ float act_grad(float dy, float z) {
  if constexpr (A == kSilu) {
    const float s = __fdividef(1.0f, 1.0f + __expf(-z));
    return dy * s * (1.0f + z * (1.0f - s));
  } else if constexpr (A == kLeaky) {
    return z > 0.0f ? dy : dy * kLeakySlope;
  } else {
    return dy;
  }
}

// --- the statistics and the per-channel affine, as the plain version forms them --------------

struct Stats {
  float mean, inv, gate;  // gate: 1 where E[x^2] - mean^2 >= 0 (the clamp passes its gradient)
};

// From the group's sums [sum x (N*G), sum x^2 (N*G), count].
__device__ __forceinline__ Stats stats_of(const float* __restrict__ sums, int ng, int groups, float eps) {
  const float count = sums[2 * groups];
  const float mean = __fdiv_rn(sums[ng], count);
  const float var = __fsub_rn(__fdiv_rn(sums[groups + ng], count), __fmul_rn(mean, mean));
  return {mean, rsqrtf(__fadd_rn(fmaxf(var, 0.0f), eps)), var >= 0.0f ? 1.0f : 0.0f};
}

// scale and offset of one channel in fp32, each rounded to T; z of one element.
template <typename T>
__device__ __forceinline__ float scale_of(float inv, float w) {
  return rnd<T>(__fmul_rn(inv, w));
}
template <typename T>
__device__ __forceinline__ float offset_of(float mean, float inv, float w, float b) {
  return rnd<T>(__fsub_rn(b, __fmul_rn(__fmul_rn(mean, inv), w)));
}
template <typename T>
__device__ __forceinline__ float z_of(float x, float scale, float offset) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, scale)), offset));
}

// The group's sum_c w A and sum_c w B over its C/G channels, A and B its channels' (per-sample) sums.
__device__ __forceinline__ float2 weighted_sums(const float* __restrict__ w, const float* __restrict__ sums_nc,
                                                int n, int ch, int c, int cpg, long long nc) {
  const int first = ch - ch % cpg;
  const float* a = sums_nc + static_cast<long long>(n) * c + first;
  float wa = 0.0f, wb = 0.0f;
  for (int j = 0; j < cpg; ++j) wa = fmaf(w[first + j], a[j], wa), wb = fmaf(w[first + j], a[nc + j], wb);
  return make_float2(wa, wb);
}

// --- shapes -----------------------------------------------------------------------------------

struct Shape {
  int n, c, cpg, groups;  // groups: N * G
  long long s, chunk;     // a row's elements (rows) or a sample's positions (channels last); a block's slice
  int chunks;             // blocks a row, or a sample
  long long sn, sc, sk;   // strides of the partial sums' (sample, channel, chunk) index
};

// The row's (n, c), its group's index n * G + g, and the block's slice [lo, hi) of the row.
struct Row {
  long long row, lo, hi;
  int ch, ng;
};

__device__ __forceinline__ Row this_row(const Shape& sh) {
  Row r;
  r.row = blockIdx.x;
  const int n = static_cast<int>(r.row / sh.c);
  r.ch = static_cast<int>(r.row % sh.c);
  r.ng = n * (sh.c / sh.cpg) + r.ch / sh.cpg;
  r.lo = static_cast<long long>(blockIdx.y) * sh.chunk;
  r.hi = min(sh.s, r.lo + sh.chunk);
  return r;
}

// A channels-last block: sample n, positions [lo, hi), this thread's channel vector cv (channels
// cv V .. cv V + V - 1) and lane (its positions lo + lane, lo + lane + lanes, ...).
struct ClBlock {
  int n, cv, lane, lanes;
  long long lo, hi, base;  // base: the sample's first element
};

template <int V>
__device__ __forceinline__ ClBlock this_block(const Shape& sh) {
  ClBlock b;
  const int cvs = sh.c / V;
  b.n = blockIdx.x;
  b.cv = threadIdx.x % cvs;
  b.lane = threadIdx.x / cvs;
  b.lanes = kThreads / cvs;
  b.lo = static_cast<long long>(blockIdx.y) * sh.chunk;
  b.hi = min(sh.s, b.lo + sh.chunk);
  b.base = static_cast<long long>(b.n) * sh.s * sh.c;
  return b;
}

// Walks a block's slice of a row: each thread V elements at a time of each of the K rows `in`,
// kLoads / K vectors of each loaded before any is used (use(i, values[K][V]) at element i),
// neighbouring threads on neighbouring 16 bytes. A vector path (V > 1) needs S and the chunk to
// be multiples of V, so a vector never crosses the slice's end.
template <typename T, int V, int K, typename F>
__device__ __forceinline__ void walk(const Row& r, const T* const (&in)[K], F&& use) {
  constexpr int kUnroll = kLoads / K;
  constexpr long long kStep = static_cast<long long>(kThreads) * V;
  for (long long base = r.lo + static_cast<long long>(threadIdx.x) * V; base < r.hi; base += kStep * kUnroll) {
    float v[kUnroll][K][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kStep;
      if (i < r.hi) {
#pragma unroll
        for (int k = 0; k < K; ++k) load<T, V>(in[k] + i, v[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kStep;
      if (i < r.hi) use(i, v[u]);
    }
  }
}

// The same over a channels-last block: at each of the thread's positions its V channels of each
// of the K tensors `in` (sample bases); use(offset in the sample, values[K][V]).
template <typename T, int V, int K, typename F>
__device__ __forceinline__ void walk_cl(const ClBlock& b, long long c, const T* const (&in)[K], F&& use) {
  constexpr int kUnroll = kLoads / K;
  for (long long p = b.lo + b.lane; p < b.hi; p += static_cast<long long>(b.lanes) * kUnroll) {
    float v[kUnroll][K][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + static_cast<long long>(u) * b.lanes;
      if (q < b.hi) {
#pragma unroll
        for (int k = 0; k < K; ++k) load<T, V>(in[k] + q * c + b.cv * V, v[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + static_cast<long long>(u) * b.lanes;
      if (q < b.hi) use(q * c + b.cv * V, v[u]);
    }
  }
}

// The block's sum of (a, b), exact order fixed: a butterfly in each warp, then the warps in
// order, in S (float or double). Valid in thread 0, as fp32; every thread must call it.
template <typename S>
__device__ __forceinline__ float2 block_sum(S a, S b) {
  __shared__ S warp_sums[2][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[0][threadIdx.x >> 5] = a, warp_sums[1][threadIdx.x >> 5] = b;
  __syncthreads();
  S ta = 0, tb = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) ta += warp_sums[0][i], tb += warp_sums[1][i];
  }
  __syncthreads();  // warp_sums may be written again by a next call
  return make_float2(static_cast<float>(ta), static_cast<float>(tb));
}

// A channels-last block's sums (a, b) of each channel over its lanes, in S, in a fixed order:
// a butterfly over the lanes that share a warp, then the warps in order in shared memory;
// emit(c, sum a, sum b) for every channel c of the sample, each by one thread. Every thread calls it.
template <typename S, int V, typename F>
__device__ __forceinline__ void channel_sums(S (&a)[V], S (&b)[V], int c, F&& emit) {
  __shared__ S buf[2][kThreads][V];
  const int cvs = c / V, lanes = kThreads / cvs;
  for (int off = 16; off >= cvs; off >>= 1) {  // threads t and t ^ off hold the same channels
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
      b[j] += __shfl_xor_sync(0xffffffffu, b[j], off);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) buf[0][threadIdx.x][j] = a[j], buf[1][threadIdx.x][j] = b[j];
  __syncthreads();
  const int step = cvs < 32 ? 32 / cvs : 1;  // the lanes a warp holds, summed by the butterfly
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int cv = ch / V, j = ch % V;
    S sa = 0, sb = 0;
    for (int l = 0; l < lanes; l += step) sa += buf[0][l * cvs + cv][j], sb += buf[1][l * cvs + cv][j];
    emit(ch, static_cast<float>(sa), static_cast<float>(sb));
  }
  __syncthreads();
}

// Per-channel constants of a channels-last block: f(ch, values[K]) for each channel of the sample,
// one thread a channel, into shared memory; then each thread's K values of its V channels.
template <int K, int V, typename F>
__device__ __forceinline__ void channel_table(int c, int cv, float (&out)[K][V], F&& f) {
  __shared__ float table[K][kMaxClChannels];
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float values[K];
    f(ch, values);
#pragma unroll
    for (int k = 0; k < K; ++k) table[k][ch] = values[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) out[k][j] = table[k][cv * V + j];
  }
}

// --- forward, rows -----------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) group_norm_moments_partial(const T* __restrict__ x,
                                                                       float2* __restrict__ partial, Shape sh) {
  const Row r = this_row(sh);
  const T* const in[1] = {x + r.row * sh.s};
  Acc<T> sx = 0, sxx = 0;
  walk<T, V, 1>(r, in, [&](long long, const float (&v)[1][V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) sx += v[0][j], sxx += static_cast<Acc<T>>(v[0][j]) * v[0][j];
  });
  const float2 total = block_sum(sx, sxx);
  if (threadIdx.x == 0) partial[r.row * sh.chunks + blockIdx.y] = total;
}

// stats: [mean (N*G), inv (N*G), gate (N*G), count], written by the first block of each
// group's first channel.
template <typename T, int V, int A>
__global__ void __launch_bounds__(kThreads) group_norm_apply(const T* __restrict__ x, const float* __restrict__ w,
                                                             const float* __restrict__ b,
                                                             const float* __restrict__ sums,
                                                             float* __restrict__ stats, T* __restrict__ y, Shape sh,
                                                             float eps) {
  const Row r = this_row(sh);
  const Stats st = stats_of(sums, r.ng, sh.groups, eps);
  if (threadIdx.x == 0 && blockIdx.y == 0 && r.ch % sh.cpg == 0) {
    stats[r.ng] = st.mean, stats[sh.groups + r.ng] = st.inv, stats[2 * sh.groups + r.ng] = st.gate;
    if (r.row == 0) stats[3 * sh.groups] = sums[2 * sh.groups];
  }
  const float scale = scale_of<T>(st.inv, w[r.ch]), offset = offset_of<T>(st.mean, st.inv, w[r.ch], b[r.ch]);
  const T* const in[1] = {x + r.row * sh.s};
  T* yr = y + r.row * sh.s;
  walk<T, V, 1>(r, in, [&](long long i, const float (&v)[1][V]) {
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = rnd<T>(act<A>(z_of<T>(v[0][j], scale, offset)));
    store<T, V>(yr + i, out);
  });
}

// --- forward, channels last --------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) group_norm_cl_moments_partial(const T* __restrict__ x,
                                                                          float2* __restrict__ partial, Shape sh) {
  const ClBlock blk = this_block<V>(sh);
  const T* const in[1] = {x + blk.base};
  Acc<T> sx[V] = {}, sxx[V] = {};
  walk_cl<T, V, 1>(blk, sh.c, in, [&](long long, const float (&v)[1][V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) sx[j] += v[0][j], sxx[j] += static_cast<Acc<T>>(v[0][j]) * v[0][j];
  });
  channel_sums<Acc<T>, V>(sx, sxx, sh.c, [&](int ch, float a, float bb) {
    partial[blk.n * sh.sn + ch * sh.sc + blockIdx.y * sh.sk] = make_float2(a, bb);
  });
}

template <typename T, int V, int A>
__global__ void __launch_bounds__(kThreads) group_norm_cl_apply(const T* __restrict__ x, const float* __restrict__ w,
                                                                const float* __restrict__ b,
                                                                const float* __restrict__ sums,
                                                                float* __restrict__ stats, T* __restrict__ y,
                                                                Shape sh, float eps) {
  const ClBlock blk = this_block<V>(sh);
  float k[2][V];  // scale, offset
  channel_table<2, V>(sh.c, blk.cv, k, [&](int ch, float (&out)[2]) {
    const int ng = blk.n * (sh.c / sh.cpg) + ch / sh.cpg;
    const Stats st = stats_of(sums, ng, sh.groups, eps);
    if (blockIdx.y == 0 && ch % sh.cpg == 0)
      stats[ng] = st.mean, stats[sh.groups + ng] = st.inv, stats[2 * sh.groups + ng] = st.gate;
    out[0] = scale_of<T>(st.inv, w[ch]);
    out[1] = offset_of<T>(st.mean, st.inv, w[ch], b[ch]);
  });
  const float (&scale)[V] = k[0], (&offset)[V] = k[1];
  if (blockIdx.y == 0 && blk.n == 0 && threadIdx.x == 0) stats[3 * sh.groups] = sums[2 * sh.groups];
  const T* const in[1] = {x + blk.base};
  T* ys = y + blk.base;
  walk_cl<T, V, 1>(blk, sh.c, in, [&](long long i, const float (&v)[1][V]) {
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = rnd<T>(act<A>(z_of<T>(v[0][j], scale[j], offset[j])));
    store<T, V>(ys + i, out);
  });
}

// One block a group: its channels' partials, channel by channel and chunk by chunk.
// sums: [sum x (N*G), sum x^2 (N*G), count].
__global__ void __launch_bounds__(kThreads) group_norm_moments_group(const float2* __restrict__ partial,
                                                                     float* __restrict__ sums, Shape sh) {
  const int ng = blockIdx.x, gpn = sh.c / sh.cpg;
  const int n = ng / gpn, first = ng % gpn * sh.cpg;
  const int count = sh.cpg * sh.chunks;
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const float2 p = partial[n * sh.sn + (first + i / sh.chunks) * sh.sc + (i % sh.chunks) * sh.sk];
    a += p.x, b += p.y;
  }
  const float2 total = block_sum<float>(a, b);
  if (threadIdx.x == 0) {
    sums[ng] = total.x;
    sums[sh.groups + ng] = total.y;
    if (ng == 0) sums[2 * sh.groups] = static_cast<float>(static_cast<long long>(sh.cpg) * sh.s);
  }
}

// --- backward, rows ----------------------------------------------------------------------------

template <typename T, int V, int A>
__global__ void __launch_bounds__(kThreads) group_norm_bwd_partial(const T* __restrict__ x,
                                                                   const T* __restrict__ dy,
                                                                   const float* __restrict__ w,
                                                                   const float* __restrict__ b,
                                                                   const float* __restrict__ stats,
                                                                   float2* __restrict__ partial, Shape sh) {
  const Row r = this_row(sh);
  const float mean = stats[r.ng], inv = stats[sh.groups + r.ng];
  const float scale = scale_of<T>(inv, w[r.ch]), offset = offset_of<T>(mean, inv, w[r.ch], b[r.ch]);
  const T* const in[2] = {x + r.row * sh.s, dy + r.row * sh.s};
  Acc<T> sa = 0, sb = 0;
  walk<T, V, 2>(r, in, [&](long long, const float (&v)[2][V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = act_grad<A>(v[1][j], z_of<T>(v[0][j], scale, offset));
      sa += dz;
      sb += static_cast<Acc<T>>(dz) * (v[0][j] - mean);
    }
  });
  const float2 total = block_sum(sa, sb);
  if (threadIdx.x == 0) partial[r.row * sh.chunks + blockIdx.y] = total;
}

template <typename T, int V, int A>
__global__ void __launch_bounds__(kThreads) group_norm_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
                                                              const float* __restrict__ w,
                                                              const float* __restrict__ b,
                                                              const float* __restrict__ stats,
                                                              const float* __restrict__ sums_nc,
                                                              T* __restrict__ dx, Shape sh) {
  const Row r = this_row(sh);
  const float mean = stats[r.ng], inv = stats[sh.groups + r.ng], gate = stats[2 * sh.groups + r.ng];
  const float count = stats[3 * sh.groups];
  const float2 wab = weighted_sums(w, sums_nc, static_cast<int>(r.row / sh.c), r.ch, sh.c, sh.cpg,
                                   static_cast<long long>(sh.n) * sh.c);
  const float coef_x = -gate * inv * inv * inv * wab.y / count, coef_0 = -inv * wab.x / count;
  const float scale = scale_of<T>(inv, w[r.ch]), offset = offset_of<T>(mean, inv, w[r.ch], b[r.ch]);
  const T* const in[2] = {x + r.row * sh.s, dy + r.row * sh.s};
  T* dxr = dx + r.row * sh.s;
  walk<T, V, 2>(r, in, [&](long long i, const float (&v)[2][V]) {
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = act_grad<A>(v[1][j], z_of<T>(v[0][j], scale, offset));
      out[j] = rnd<T>(fmaf(dz, scale, fmaf(coef_x, v[0][j] - mean, coef_0)));
    }
    store<T, V>(dxr + i, out);
  });
}

// --- backward, channels last -------------------------------------------------------------------

template <typename T, int V, int A>
__global__ void __launch_bounds__(kThreads) group_norm_cl_bwd_partial(const T* __restrict__ x,
                                                                      const T* __restrict__ dy,
                                                                      const float* __restrict__ w,
                                                                      const float* __restrict__ b,
                                                                      const float* __restrict__ stats,
                                                                      float2* __restrict__ partial, Shape sh) {
  const ClBlock blk = this_block<V>(sh);
  float k[3][V];  // mean, scale, offset
  channel_table<3, V>(sh.c, blk.cv, k, [&](int ch, float (&out)[3]) {
    const int ng = blk.n * (sh.c / sh.cpg) + ch / sh.cpg;
    const float mean = stats[ng], inv = stats[sh.groups + ng];
    out[0] = mean, out[1] = scale_of<T>(inv, w[ch]), out[2] = offset_of<T>(mean, inv, w[ch], b[ch]);
  });
  const float (&mean)[V] = k[0], (&scale)[V] = k[1], (&offset)[V] = k[2];
  const T* const in[2] = {x + blk.base, dy + blk.base};
  Acc<T> sa[V] = {}, sb[V] = {};
  walk_cl<T, V, 2>(blk, sh.c, in, [&](long long, const float (&v)[2][V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = act_grad<A>(v[1][j], z_of<T>(v[0][j], scale[j], offset[j]));
      sa[j] += dz;
      sb[j] += static_cast<Acc<T>>(dz) * (v[0][j] - mean[j]);
    }
  });
  channel_sums<Acc<T>, V>(sa, sb, sh.c, [&](int ch, float a, float bb) {
    partial[blk.n * sh.sn + ch * sh.sc + blockIdx.y * sh.sk] = make_float2(a, bb);
  });
}

template <typename T, int V, int A>
__global__ void __launch_bounds__(kThreads) group_norm_cl_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
                                                                 const float* __restrict__ w,
                                                                 const float* __restrict__ b,
                                                                 const float* __restrict__ stats,
                                                                 const float* __restrict__ sums_nc,
                                                                 T* __restrict__ dx, Shape sh) {
  const ClBlock blk = this_block<V>(sh);
  const float count = stats[3 * sh.groups];
  float k[5][V];  // mean, scale, offset, coef_x, coef_0
  channel_table<5, V>(sh.c, blk.cv, k, [&](int ch, float (&out)[5]) {
    const int ng = blk.n * (sh.c / sh.cpg) + ch / sh.cpg;
    const float mean = stats[ng], inv = stats[sh.groups + ng], gate = stats[2 * sh.groups + ng];
    const float2 wab = weighted_sums(w, sums_nc, blk.n, ch, sh.c, sh.cpg, static_cast<long long>(sh.n) * sh.c);
    out[0] = mean, out[1] = scale_of<T>(inv, w[ch]), out[2] = offset_of<T>(mean, inv, w[ch], b[ch]);
    out[3] = -gate * inv * inv * inv * wab.y / count, out[4] = -inv * wab.x / count;
  });
  const float (&mean)[V] = k[0], (&scale)[V] = k[1], (&offset)[V] = k[2];
  const float (&coef_x)[V] = k[3], (&coef_0)[V] = k[4];
  const T* const in[2] = {x + blk.base, dy + blk.base};
  T* dxs = dx + blk.base;
  walk_cl<T, V, 2>(blk, sh.c, in, [&](long long i, const float (&v)[2][V]) {
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = act_grad<A>(v[1][j], z_of<T>(v[0][j], scale[j], offset[j]));
      out[j] = rnd<T>(fmaf(dz, scale[j], fmaf(coef_x[j], v[0][j] - mean[j], coef_0[j])));
    }
    store<T, V>(dxs + i, out);
  });
}

// --- backward, both layouts --------------------------------------------------------------------

// One block a channel: A[n, c] and B[n, c] from its chunks' partials, n in order, then
// dw[c] = sum_n inv B and db[c] = sum_n A. sums_nc: [A (N*C), B (N*C)]; dwdb: [dw (C), db (C)].
__global__ void __launch_bounds__(kThreads) group_norm_bwd_channel(const float2* __restrict__ partial,
                                                                   const float* __restrict__ stats,
                                                                   float* __restrict__ sums_nc,
                                                                   float* __restrict__ dwdb, Shape sh) {
  const int ch = blockIdx.x;
  float dw = 0.0f, db = 0.0f;
  for (int n = 0; n < sh.n; ++n) {
    const float2* p = partial + n * sh.sn + ch * sh.sc;
    float a = 0.0f, b = 0.0f;
    for (int k = threadIdx.x; k < sh.chunks; k += kThreads) a += p[k * sh.sk].x, b += p[k * sh.sk].y;
    const float2 total = block_sum<float>(a, b);
    if (threadIdx.x == 0) {
      const long long nc = static_cast<long long>(n) * sh.c + ch;
      sums_nc[nc] = total.x;
      sums_nc[static_cast<long long>(sh.n) * sh.c + nc] = total.y;
      dw = fmaf(stats[sh.groups + n * (sh.c / sh.cpg) + ch / sh.cpg], total.y, dw);
      db += total.x;
    }
  }
  if (threadIdx.x == 0) dwdb[ch] = dw, dwdb[sh.c + ch] = db;
}

// --- launch ----------------------------------------------------------------------------------

// The shape, or false for arguments no kernel takes. Rows: the grid is (N * C, chunks), a
// vector path needs S and the chunk to be multiples of the vector. Channels last: the grid is
// (N, chunks), C a multiple of the vector, C / vector a divisor of the block's threads and C at
// most kMaxClChannels. A
// grid beyond the card's limits is left to the launch to refuse (cudaGetLastError).
bool make_shape(int mode, int is_bf16, int n, int c, int groups, long long s, long long chunk, Shape* sh) {
  const int v = is_bf16 ? 8 : 4;
  if (n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || s < 0 || chunk <= 0) return false;
  if (mode == kRowsVec && (s % v != 0 || chunk % v != 0)) return false;
  if (mode == kChannelsLast && (c % v != 0 || kThreads % (c / v) != 0 || c > kMaxClChannels)) return false;
  if (mode < kRows || mode > kChannelsLast) return false;
  const long long chunks = s == 0 ? 1 : (s + chunk - 1) / chunk;  // an empty slab still writes its sums
  if (chunks > (1LL << 30)) return false;
  sh->n = n, sh->c = c, sh->cpg = c / groups, sh->groups = n * groups;
  sh->s = s, sh->chunk = chunk, sh->chunks = static_cast<int>(chunks);
  if (mode == kChannelsLast) sh->sn = chunks * c, sh->sc = 1, sh->sk = c;
  else sh->sn = c * chunks, sh->sc = chunks, sh->sk = 1;
  return true;
}

dim3 grid(const Shape& sh, bool channels_last) {
  return dim3(static_cast<unsigned>(channels_last ? sh.n : static_cast<long long>(sh.n) * sh.c),
              static_cast<unsigned>(sh.chunks));
}

// One launch's arguments; run<T, V, A>() launches it for a dtype, vector width and activation
// (channels last only with V > 1) and returns cudaGetLastError() (the first error, for two).
struct Moments {
  const void* x;
  void *partial, *sums;
  bool cl;
  Shape sh;
  cudaStream_t stream;
  template <typename T, int V, int A>
  int run() const {
    auto p = static_cast<float2*>(partial);
    const T* xs = static_cast<const T*>(x);
    if constexpr (V > 1) {
      if (cl) group_norm_cl_moments_partial<T, V><<<grid(sh, true), kThreads, 0, stream>>>(xs, p, sh);
    }
    if (!cl) group_norm_moments_partial<T, V><<<grid(sh, false), kThreads, 0, stream>>>(xs, p, sh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_norm_moments_group<<<sh.groups, kThreads, 0, stream>>>(p, static_cast<float*>(sums), sh);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Apply {
  const void *x, *w, *b, *sums;
  void *stats, *y;
  float eps;
  bool cl;
  Shape sh;
  cudaStream_t stream;
  template <typename T, int V, int A>
  int run() const {
    const T* xs = static_cast<const T*>(x);
    const float *ws = static_cast<const float*>(w), *bs = static_cast<const float*>(b);
    const float* ss = static_cast<const float*>(sums);
    float* st = static_cast<float*>(stats);
    T* out = static_cast<T*>(y);
    if constexpr (V > 1) {
      if (cl) group_norm_cl_apply<T, V, A><<<grid(sh, true), kThreads, 0, stream>>>(xs, ws, bs, ss, st, out, sh, eps);
    }
    if (!cl) group_norm_apply<T, V, A><<<grid(sh, false), kThreads, 0, stream>>>(xs, ws, bs, ss, st, out, sh, eps);
    return static_cast<int>(cudaGetLastError());
  }
};

struct BwdSums {
  const void *x, *dy, *w, *b, *stats;
  void *partial, *sums_nc, *dwdb;
  bool cl;
  Shape sh;
  cudaStream_t stream;
  template <typename T, int V, int A>
  int run() const {
    auto p = static_cast<float2*>(partial);
    const T *xs = static_cast<const T*>(x), *dys = static_cast<const T*>(dy);
    const float *ws = static_cast<const float*>(w), *bs = static_cast<const float*>(b);
    const float* st = static_cast<const float*>(stats);
    if constexpr (V > 1) {
      if (cl) group_norm_cl_bwd_partial<T, V, A><<<grid(sh, true), kThreads, 0, stream>>>(xs, dys, ws, bs, st, p, sh);
    }
    if (!cl) group_norm_bwd_partial<T, V, A><<<grid(sh, false), kThreads, 0, stream>>>(xs, dys, ws, bs, st, p, sh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_norm_bwd_channel<<<sh.c, kThreads, 0, stream>>>(p, st, static_cast<float*>(sums_nc),
                                                          static_cast<float*>(dwdb), sh);
    return static_cast<int>(cudaGetLastError());
  }
};

struct BwdDx {
  const void *x, *dy, *w, *b, *stats, *sums_nc;
  void* dx;
  bool cl;
  Shape sh;
  cudaStream_t stream;
  template <typename T, int V, int A>
  int run() const {
    const T *xs = static_cast<const T*>(x), *dys = static_cast<const T*>(dy);
    const float *ws = static_cast<const float*>(w), *bs = static_cast<const float*>(b);
    const float *st = static_cast<const float*>(stats), *snc = static_cast<const float*>(sums_nc);
    T* out = static_cast<T*>(dx);
    if constexpr (V > 1) {
      if (cl) group_norm_cl_bwd_dx<T, V, A><<<grid(sh, true), kThreads, 0, stream>>>(xs, dys, ws, bs, st, snc, out, sh);
    }
    if (!cl) group_norm_bwd_dx<T, V, A><<<grid(sh, false), kThreads, 0, stream>>>(xs, dys, ws, bs, st, snc, out, sh);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int V, typename Op>
int with_act(int activation, const Op& op) {
  switch (activation) {
    case kSilu:
      return op.template run<T, V, kSilu>();
    case kLeaky:
      return op.template run<T, V, kLeaky>();
    default:
      return op.template run<T, V, kNone>();
  }
}

// Launches op for the runtime dtype, layout (mode) and activation; arguments no kernel takes
// (a bad shape, a layout the vectors do not fit, an unknown activation or mode) return
// cudaErrorInvalidValue and launch nothing.
template <typename Op>
int dispatch(int is_bf16, int mode, int activation, int n, int c, int groups, long long s, long long chunk, Op op) {
  if (activation < kNone || activation > kLeaky || !make_shape(mode, is_bf16, n, c, groups, s, chunk, &op.sh))
    return static_cast<int>(cudaErrorInvalidValue);
  op.cl = mode == kChannelsLast;
  if (mode == kRows) return is_bf16 ? with_act<__nv_bfloat16, 1>(activation, op) : with_act<float, 1>(activation, op);
  return is_bf16 ? with_act<__nv_bfloat16, 8>(activation, op) : with_act<float, 4>(activation, op);
}

}  // namespace

// The entry points. mode: 0 rows element by element, 1 rows in 16-byte vectors, 2 channels
// last; n, c, groups; s: a row's elements or a sample's positions; chunk: a block's slice of
// them. Each returns a CUDA error code.

// Forward, first part: the groups' sums into sums [sum x (N*G), sum x^2 (N*G), count];
// partial holds N * C * chunks float2.
extern "C" int cips_group_norm_moments(const void* x, void* partial, void* sums, int is_bf16, int mode, int n, int c,
                                       int groups, long long s, long long chunk, void* stream) {
  return dispatch(is_bf16, mode, kNone, n, c, groups, s, chunk,
                  Moments{x, partial, sums, false, Shape{}, static_cast<cudaStream_t>(stream)});
}

// Forward, second part: y = act(norm(x)) from sums (all-reduced over a space group), and the
// statistics the backward reads into stats [mean (N*G), inv (N*G), gate (N*G), count].
extern "C" int cips_group_norm_apply(const void* x, const void* w, const void* b, const void* sums, void* stats,
                                     void* y, int is_bf16, int mode, int activation, int n, int c, int groups,
                                     long long s, long long chunk, float eps, void* stream) {
  return dispatch(is_bf16, mode, activation, n, c, groups, s, chunk,
                  Apply{x, w, b, sums, stats, y, eps, false, Shape{}, static_cast<cudaStream_t>(stream)});
}

// Backward, first part: sums_nc [A (N*C), B (N*C)] and this rank's dw, db into dwdb [dw (C),
// db (C)]; partial holds N * C * chunks float2.
extern "C" int cips_group_norm_bwd_sums(const void* x, const void* dy, const void* w, const void* b,
                                        const void* stats, void* partial, void* sums_nc, void* dwdb, int is_bf16,
                                        int mode, int activation, int n, int c, int groups, long long s,
                                        long long chunk, void* stream) {
  return dispatch(is_bf16, mode, activation, n, c, groups, s, chunk,
                  BwdSums{x, dy, w, b, stats, partial, sums_nc, dwdb, false, Shape{},
                          static_cast<cudaStream_t>(stream)});
}

// Backward, second part: dx from sums_nc (all-reduced over a space group).
extern "C" int cips_group_norm_bwd_dx(const void* x, const void* dy, const void* w, const void* b, const void* stats,
                                      const void* sums_nc, void* dx, int is_bf16, int mode, int activation, int n,
                                      int c, int groups, long long s, long long chunk, void* stream) {
  return dispatch(is_bf16, mode, activation, n, c, groups, s, chunk,
                  BwdDx{x, dy, w, b, stats, sums_nc, dx, false, Shape{}, static_cast<cudaStream_t>(stream)});
}
