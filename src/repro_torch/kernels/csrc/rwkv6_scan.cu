// RWKV6 WKV recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (Pallas).
// It computes what that kernel computes, not its block structure:
//
//   y_t[j] = sum_i r_t[i] S[i,j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]
//
// per (batch, head), with the (D,D) state in fp32 and D = 64.
//
// Design: one thread block per (batch, head), 64 threads.  Thread j keeps the
// state column S[:, j] in 64 fp32 registers for the whole sequence; the time
// loop runs inside the block, so there are no chunks and no padding.  For each
// t the block stages r_t, w_t, k_t and the bonus terms r_t u k_t in shared
// memory (double-buffered, so one barrier per step), and every thread reads
// them as broadcasts.  The inputs for t+1 are loaded into registers while step
// t computes.  r/k/v/w are (B,T,H,D) tensors read through their strides (the
// last stride must be 1); y is written contiguous (B,T,H,D) in the input type.
// u is (H,D) in the same type as r/k/v/w (float32 or bfloat16), read as fp32.
//
// In-place state: each block reads its whole slice of s0 into registers
// before it writes any of sT, and no block touches another block's slice.  So
// sT may be the same buffer as s0, which lets a caller advance a slot pool's
// per-layer state without a copy.  Neither pointer is __restrict__ for that
// reason.
//
// What bounds it on an H100: at decode (T = 1) the fp32 state is read and
// written once per call, 2*B*H*64*64*4 bytes (8.4 MB at 8 slots and 32
// heads), so it is bound by bytes.  At prefill the bound is the serial
// dependence over T: each step is ~5*64*64 flops per block, and only B*H
// blocks (32 at batch 1) can run at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(D) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u, const float* s0,
    T* __restrict__ y, float* sT, int n_t, int n_h, long long sb, long long st,
    long long sh) {
  const int bh = blockIdx.x;
  const int b = bh / n_h;
  const int h = bh % n_h;
  const int j = threadIdx.x;

  __shared__ float sh_r[2][D];
  __shared__ float sh_w[2][D];
  __shared__ float sh_k[2][D];
  __shared__ float sh_ruk[2][D];

  float S[D];
  const float* s_in = s0 + (long long)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s_in[i * D + j];
  const float u_j = to_float(u[h * D + j]);

  const long long base = (long long)b * sb + (long long)h * sh + j;
  float r_n = to_float(r[base]), k_n = to_float(k[base]);
  float v_n = to_float(v[base]), w_n = to_float(w[base]);
  T* y_bh = y + ((long long)b * n_t * n_h + h) * D + j;

  for (int t = 0; t < n_t; ++t) {
    const float r_j = r_n, k_j = k_n, v_j = v_n, w_j = w_n;
    if (t + 1 < n_t) {
      const long long off = base + (long long)(t + 1) * st;
      r_n = to_float(r[off]);
      k_n = to_float(k[off]);
      v_n = to_float(v[off]);
      w_n = to_float(w[off]);
    }
    const int buf = t & 1;
    sh_r[buf][j] = r_j;
    sh_w[buf][j] = w_j;
    sh_k[buf][j] = k_j;
    sh_ruk[buf][j] = r_j * u_j * k_j;
    __syncthreads();

    float acc = 0.f, ruk = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc = fmaf(sh_r[buf][i], S[i], acc);
      ruk += sh_ruk[buf][i];
    }
    y_bh[(long long)t * n_h * D] = from_float<T>(fmaf(ruk, v_j, acc));
#pragma unroll
    for (int i = 0; i < D; ++i) S[i] = fmaf(sh_w[buf][i], S[i], sh_k[buf][i] * v_j);
  }

  float* s_out = sT + (long long)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) s_out[i * D + j] = S[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const float* s0, void* y, float* sT, int n_b,
                   int n_t, int n_h, long long sb, long long st, long long sh,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<T><<<n_b * n_h, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), s0, static_cast<T*>(y), sT,
      n_t, n_h, sb, st, sh);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (r/k/v/w/u and y): 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); an unknown dtype code
// returns cudaErrorInvalidValue.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const float* s0, void* y,
                              float* sT, int n_b, int n_t, int n_h, long long sb,
                              long long st, long long sh, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, y, sT, n_b, n_t, n_h, sb, st, sh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, n_b, n_t, n_h, sb, st, sh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
