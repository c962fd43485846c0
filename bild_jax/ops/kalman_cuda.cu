// Rouse-Kalman likelihood on a CUDA card (Hopper, sm_90a): one warp per
// profile, the profile's covariance and mean resident on chip for the whole
// frame loop. Same semantics as `bild_jax/ops/kalman.py`
// (`msrouse_logL_batch`), which is its reference.
//
// Per profile and frame, lane i owns row i of the mean M (N, d) and of each
// of the q covariance copies C (q, N, N). Propagation through the profile's
// OWN state s applies B_s C B_s + Sig_s as two row-times-matrix passes
// (X = B_s C, then X B_s; B_s is symmetric) whose matrix rows are read as
// 16-byte broadcasts from shared memory; the measurement update reduces
// across the warp with shuffles. All arithmetic is IEEE fp32 FMA at the
// exact N: rows are padded to a multiple of 4 floats in shared memory only.
//
// The monomer count N and spatial dimension d are compile-time constants
// (-DBILD_N, -DBILD_D), so the rows live in registers.
//
// Inputs may carry leading batch dimensions (vmap over trajectories, every
// input broadcast to them); each batch element g is one trajectory with its
// own model arrays, and its own run of ceil(P / WARPS) consecutive blocks
// of a one-dimensional grid (grid.x holds 2^31 - 1 blocks; grid.y only
// 65535, fewer than a vmap over k and thousands of trajectories needs).

#include <cmath>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

#ifndef BILD_N
#error "compile with -DBILD_N=<monomers>"
#endif
#ifndef BILD_D
#error "compile with -DBILD_D=<spatial dimensions>"
#endif

constexpr int N = BILD_N;          // monomers: covariance rows, one lane each
constexpr int D = BILD_D;          // spatial dimensions (q <= D copies)
constexpr int S = (N + 3) & ~3;    // shared-memory row stride (16-byte rows)
constexpr int DS = (D + 3) & ~3;   // row stride of the mean
constexpr int WARPS = 4;           // profiles per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG_2PI = 1.8378770664093453f;
static_assert(N >= 1 && N <= 32, "one warp lane per covariance row");
static_assert(D >= 1 && D <= 8, "spatial dimension");

// floats of shared memory: the block's model, then one slot per warp
__host__ __device__ constexpr int model_floats(int n) {
  return 2 * n * N * S + n * N * DS + S;
}
constexpr int kWarpFloats = D * N * S + N * DS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// f(j, row[j]) for j < N, reading the row as float4
template <int W, typename F>
__device__ __forceinline__ void row_apply(const float* row, F&& f) {
#pragma unroll
  for (int c = 0; c < (W + 3) / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(row)[c];
    if (4 * c + 0 < W) f(4 * c + 0, v.x);
    if (4 * c + 1 < W) f(4 * c + 1, v.y);
    if (4 * c + 2 < W) f(4 * c + 2, v.z);
    if (4 * c + 3 < W) f(4 * c + 3, v.w);
  }
}

template <int W>
__device__ __forceinline__ void row_store(float* row, const float (&x)[W]) {
#pragma unroll
  for (int c = 0; c < (W + 3) / 4; ++c) {
    float4 v;
    v.x = x[4 * c];
    v.y = 4 * c + 1 < W ? x[4 * c + 1] : 0.f;
    v.z = 4 * c + 2 < W ? x[4 * c + 2] : 0.f;
    v.w = 4 * c + 3 < W ? x[4 * c + 3] : 0.f;
    reinterpret_cast<float4*>(row)[c] = v;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
rouse_kalman_kernel(const float* __restrict__ Bs, const float* __restrict__ Gs,
                    const float* __restrict__ Sigs,
                    const float* __restrict__ M0s,
                    const float* __restrict__ C0s,
                    const float* __restrict__ w, const float* __restrict__ s2,
                    const int32_t* __restrict__ Cind,
                    const int32_t* __restrict__ profiles,
                    const float* __restrict__ ydata,
                    const int32_t* __restrict__ valid,
                    float* __restrict__ out, int n, int q, int P, int T,
                    int blocks_per_g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.x / blocks_per_g;
  float* sB = smem;                 // (n, N, S)
  float* sSig = sB + n * N * S;     // (n, N, S)
  float* sG = sSig + n * N * S;     // (n, N, DS)
  float* sw = sG + n * N * DS;      // (S,)

  Bs += (size_t)g * n * N * N;
  Sigs += (size_t)g * n * N * N;
  Gs += (size_t)g * n * N * D;
  M0s += (size_t)g * n * N * D;
  C0s += (size_t)g * n * N * N;
  w += (size_t)g * N;
  s2 += (size_t)g * q;
  Cind += (size_t)g * D;
  ydata += (size_t)g * T * D;
  valid += (size_t)g * T;

  for (int idx = threadIdx.x; idx < n * N * N; idx += blockDim.x) {
    const int r = idx / N, c = idx % N;    // r runs over (state, row)
    sB[r * S + c] = Bs[idx];
    sSig[r * S + c] = Sigs[idx];
  }
  for (int idx = threadIdx.x; idx < n * N * D; idx += blockDim.x)
    sG[(idx / D) * DS + idx % D] = Gs[idx];
  for (int idx = threadIdx.x; idx < S; idx += blockDim.x)
    sw[idx] = idx < N ? w[idx] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = (blockIdx.x % blocks_per_g) * WARPS + warp;
  if (p >= P) return;
  const int32_t* prof = profiles + ((size_t)g * P + p) * T;
  float* sC = smem + model_floats(n) + warp * kWarpFloats;   // (D, N, S)
  float* sM = sC + D * N * S;                                 // (N, DS)

  const bool own = lane < N;   // lanes >= N shadow row 0 and write nothing
  const int i = own ? lane : 0;
  const float wi = own ? sw[lane] : 0.f;

  int cind[D];
  float s2v[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    cind[dd] = Cind[dd];
    s2v[dd] = dd < q ? s2[dd] : 1.f;
  }

  float C[D][N];   // row i of each covariance copy
  float M[D];      // row i of the mean
  float acc = 0.f;
  bool bad = false;

  // measurement update at frame t (reference: kalman_update_batch)
  auto update = [&](int t) {
    float Sq[D], Kq[D];
#pragma unroll
    for (int qq = 0; qq < D; ++qq) {
      Sq[qq] = 1.f;
      Kq[qq] = 0.f;
      if (qq < q) {
        float cw = 0.f;
        row_apply<N>(sw, [&](int j, float wj) { cw = fmaf(C[qq][j], wj, cw); });
        const float Sv = warp_sum(wi * cw) + s2v[qq];
        const float K = cw / Sv;
#pragma unroll
        for (int j = 0; j < N; ++j)
          C[qq][j] = fmaf(-K, __shfl_sync(FULL, cw, j), C[qq][j]);
        Sq[qq] = Sv;
        Kq[qq] = K;
      }
    }
    float ll = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float m = warp_sum(wi * M[dd]);
      const float x = __ldg(ydata + t * D + dd) - m;
      float K = Kq[0], Sd = Sq[0];
#pragma unroll
      for (int qq = 1; qq < D; ++qq)
        if (cind[dd] == qq) {
          K = Kq[qq];
          Sd = Sq[qq];
        }
      M[dd] = fmaf(K, x, M[dd]);
      ll += -0.5f * (x * x / Sd + logf(Sd) + LOG_2PI);
    }
    acc += ll;
  };

  // publish this lane's rows for the next frame's broadcasts
  auto store = [&]() {
    if (own) {
#pragma unroll
      for (int qq = 0; qq < D; ++qq)
        if (qq < q) row_store<N>(sC + (qq * N + i) * S, C[qq]);
      row_store<D>(sM + i * DS, M);
    }
    __syncwarp();
  };

  // frame 0: steady state of the first state
  int st_chunk = prof[lane < T ? lane : 0];
  int v_chunk = valid[lane < T ? lane : 0];
  {
    int st = __shfl_sync(FULL, st_chunk, 0);
    bad = st < 0 || st >= n;
    st = min(max(st, 0), n - 1);
#pragma unroll
    for (int qq = 0; qq < D; ++qq)
#pragma unroll
      for (int j = 0; j < N; ++j) C[qq][j] = C0s[(st * N + i) * N + j];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) M[dd] = M0s[(st * N + i) * D + dd];
    if (__shfl_sync(FULL, v_chunk, 0)) update(0);
    store();
  }

  for (int t = 1; t < T; ++t) {
    if ((t & 31) == 0) {
      st_chunk = prof[t + lane < T ? t + lane : t];
      v_chunk = valid[t + lane < T ? t + lane : t];
    }
    int st = __shfl_sync(FULL, st_chunk, t & 31);
    bad |= st < 0 || st >= n;
    st = min(max(st, 0), n - 1);
    const float* Bst = sB + st * N * S;

    float b[N];   // row i of B_s
    row_apply<N>(Bst + i * S, [&](int k, float v) { b[k] = v; });

    // M <- B_s M + G_s
    float Mn[D];
    row_apply<D>(sG + (st * N + i) * DS, [&](int dd, float v) { Mn[dd] = v; });
#pragma unroll
    for (int k = 0; k < N; ++k)
      row_apply<D>(sM + k * DS,
                   [&](int dd, float v) { Mn[dd] = fmaf(b[k], v, Mn[dd]); });

    // C <- (B_s C) B_s + Sig_s, row i
#pragma unroll
    for (int qq = 0; qq < D; ++qq) {
      if (qq < q) {
        const float* Cq = sC + qq * N * S;
        float X[N];
#pragma unroll
        for (int j = 0; j < N; ++j) X[j] = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k)
          row_apply<N>(Cq + k * S,
                       [&](int j, float v) { X[j] = fmaf(b[k], v, X[j]); });
        row_apply<N>(sSig + (st * N + i) * S,
                     [&](int j, float v) { C[qq][j] = v; });
#pragma unroll
        for (int k = 0; k < N; ++k)
          row_apply<N>(Bst + k * S, [&](int j, float v) {
            C[qq][j] = fmaf(X[k], v, C[qq][j]);
          });
      }
    }
#pragma unroll
    for (int dd = 0; dd < D; ++dd) M[dd] = Mn[dd];
    __syncwarp();   // every lane is done reading the old C and M
    store();

    // re-symmetrize (guards f32 drift, as the reference does)
#pragma unroll
    for (int qq = 0; qq < D; ++qq)
      if (qq < q) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          C[qq][j] = 0.5f * (C[qq][j] + sC[(qq * N + j) * S + i]);
      }
    __syncwarp();   // column reads done before the rows are overwritten

    if (__shfl_sync(FULL, v_chunk, t & 31)) update(t);
    store();
  }

  if (lane == 0) out[(size_t)g * P + p] = bad ? NAN : acc;
}

static ffi::Error RouseKalmanImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> Bs, ffi::Buffer<ffi::F32> Gs,
    ffi::Buffer<ffi::F32> Sigs, ffi::Buffer<ffi::F32> M0s,
    ffi::Buffer<ffi::F32> C0s, ffi::Buffer<ffi::F32> w,
    ffi::Buffer<ffi::F32> s2, ffi::Buffer<ffi::S32> Cind,
    ffi::Buffer<ffi::S32> profiles, ffi::Buffer<ffi::F32> ydata,
    ffi::Buffer<ffi::S32> valid, ffi::ResultBuffer<ffi::F32> out) {
  const auto bd = Bs.dimensions();
  const auto pd = profiles.dimensions();
  const auto sd = s2.dimensions();
  if (bd.size() < 3 || pd.size() < 2 || sd.size() < 1)
    return ffi::Error::InvalidArgument("rouse_kalman: bad ranks");
  const int64_t n = bd[bd.size() - 3];
  const int64_t T = pd[pd.size() - 1], P = pd[pd.size() - 2];
  const int64_t q = sd[sd.size() - 1];
  if (bd[bd.size() - 1] != N || bd[bd.size() - 2] != N)
    return ffi::Error::InvalidArgument("rouse_kalman: library built for N=" +
                                       std::to_string(N));
  if (q < 1 || q > D || n < 1)
    return ffi::Error::InvalidArgument("rouse_kalman: bad n or q");
  if (P * T == 0) return ffi::Error::Success();
  const int64_t G = profiles.element_count() / (P * T);
  if (Bs.element_count() != (size_t)(G * n * N * N) ||
      Sigs.element_count() != (size_t)(G * n * N * N) ||
      C0s.element_count() != (size_t)(G * n * N * N) ||
      Gs.element_count() != (size_t)(G * n * N * D) ||
      M0s.element_count() != (size_t)(G * n * N * D) ||
      w.element_count() != (size_t)(G * N) ||
      ydata.element_count() != (size_t)(G * T * D) ||
      valid.element_count() != (size_t)(G * T) ||
      Cind.element_count() != (size_t)(G * D) ||
      s2.element_count() != (size_t)(G * q))
    return ffi::Error::InvalidArgument("rouse_kalman: inconsistent shapes");
  const int64_t blocks_per_g = (P + WARPS - 1) / WARPS;
  if (blocks_per_g * G > 0x7fffffff)
    return ffi::Error::InvalidArgument("rouse_kalman: batch too large");

  const size_t smem =
      sizeof(float) * (model_floats((int)n) + WARPS * kWarpFloats);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rouse_kalman_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess)
      return ffi::Error::Internal(std::string("rouse_kalman: ") +
                                  cudaGetErrorString(e));
  }
  rouse_kalman_kernel<<<(unsigned)(blocks_per_g * G), WARPS * 32, smem,
                        stream>>>(
      Bs.typed_data(), Gs.typed_data(), Sigs.typed_data(), M0s.typed_data(),
      C0s.typed_data(), w.typed_data(), s2.typed_data(), Cind.typed_data(),
      profiles.typed_data(), ydata.typed_data(), valid.typed_data(),
      out->typed_data(), (int)n, (int)q, (int)P, (int)T, (int)blocks_per_g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("rouse_kalman: ") +
                                cudaGetErrorString(e));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(BildRouseKalmanF32, RouseKalmanImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // Bs
                                  .Arg<ffi::Buffer<ffi::F32>>()   // Gs
                                  .Arg<ffi::Buffer<ffi::F32>>()   // Sigs
                                  .Arg<ffi::Buffer<ffi::F32>>()   // M0s
                                  .Arg<ffi::Buffer<ffi::F32>>()   // C0s
                                  .Arg<ffi::Buffer<ffi::F32>>()   // w
                                  .Arg<ffi::Buffer<ffi::F32>>()   // s2
                                  .Arg<ffi::Buffer<ffi::S32>>()   // Cind
                                  .Arg<ffi::Buffer<ffi::S32>>()   // profiles
                                  .Arg<ffi::Buffer<ffi::F32>>()   // ydata
                                  .Arg<ffi::Buffer<ffi::S32>>()   // valid
                                  .Ret<ffi::Buffer<ffi::F32>>());  // out
