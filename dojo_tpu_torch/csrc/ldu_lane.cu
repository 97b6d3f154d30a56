// The block-LDU kernels for a lane larger than a CTA's shared memory (a
// lane of atlas: W = 38, N = 62, S = 244, 22 levels; one lane's blocks take
// 252 KB in float32 and 503 KB in float64 at their real rows, against the
// 227 KB a CTA can have).
//
// The same kernels as the real-width classes of csrc/ldu.cu (17..72), built
// from its code (included below with LDU_DEVICE_ONLY, so that this library
// holds only the kernels instantiated here), with the lane's blocks kept in
// global memory, where a few lanes stay resident in L2:
//   fact_lane                 copies the lane's blocks into fb and factors
//                             them there in place (fact_body<T, true,
//                             true>): each level's block LUs, X = D_i^{-1}
//                             E_{i,b} and the Schur updates read and write
//                             fb; the LU tiles, one level's X tiles, the
//                             reciprocals, compact PS and the schedule stay
//                             in shared memory, and LU and PS are written
//                             back at the end;
//   solve_real<T, true, true> reads the edge blocks, LU and PS where they
//                             lie; the node vectors, compact PS and the
//                             schedule stay in shared memory;
//   matvec_real<T, true>      reads the blocks where they lie; the vectors
//                             and index arrays stay in shared memory.
// The schedule they take places slot sl at sl W^2 and node n's LU and PS at
// n W^2 (ldu_cuda._csr(sched, lane=True)): the layout of the tensors
// themselves.  Every other array, the order of work and the arithmetic are
// the 33..72 class's, so that every block LU is ldu.blu_factor's bitwise.
// A CTA stays on one lane; __syncthreads() orders its global writes (the
// Schur targets) before the next phase's reads.
//
// Build: as csrc/ldu.cu, into a library of its own, one a dtype (LDU_ELEM;
// ldu_cuda.build_all builds them all at once).

#define LDU_DEVICE_ONLY
#include "ldu.cu"

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
fact_lane(Sched s, FactLayout ly, const T* __restrict__ blocks, T* __restrict__ fb,
          T* __restrict__ lu, T* __restrict__ ps) {
  fact_body<T, true, true>(s, ly, blocks, fb, lu, ps);
}

template <typename T>
static int lane_factorize(const Sched* s, const FactLayout* ly, int B, const void* blocks,
                          void* fb, void* lu, void* ps, void* stream) {
  static int last[MAX_DEVICES];
  return launch(fact_lane<T>, last, true, B, NTHREADS, ly->bytes, stream, *s, *ly,
                (const T*)blocks, (T*)fb, (T*)lu, (T*)ps);
}

template <typename T>
static int lane_solve(const Sched* s, const SolveLayout* ly, int B, int k, const void* fb,
                      const void* lu, const void* ps, const void* rhs, void* out,
                      void* stream) {
  static int last[MAX_DEVICES];
  return launch(solve_real<T, true, true>, last, true, B * k, NTHREADS, ly->bytes, stream, *s,
                *ly, k, (const T*)fb, (const T*)lu, (const T*)ps, (const T*)rhs, (T*)out);
}

template <typename T>
static int lane_matvec(const Sched* s, int B, int k, int kc, int x_off, int smem,
                       const void* blocks, const void* x, void* out, void* stream) {
  static int last[MAX_DEVICES];
  if (kc < 1) return (int)cudaErrorInvalidValue;
  return launch(matvec_real<T, true>, last, true, B * ((k + kc - 1) / kc), NTHREADS, smem,
                stream, *s, k, kc, x_off, (const T*)blocks, (const T*)x, (T*)out);
}

template <typename T>
static int lane_kernel_smem(int kernel) {
  cudaFuncAttributes a;
  cudaError_t e = kernel == 0   ? cudaFuncGetAttributes(&a, fact_lane<T>)
                  : kernel == 1 ? cudaFuncGetAttributes(&a, solve_real<T, true, true>)
                  : kernel == 2 ? cudaFuncGetAttributes(&a, matvec_real<T, true>)
                                : cudaErrorInvalidValue;
  return e == cudaSuccess ? a.maxDynamicSharedSizeBytes : -1;
}

extern "C" {

int ldu_lane_max_width() { return WIDE_MAXW; }

// The dynamic shared-memory cap of kernel 0 factorize, 1 solve, 2 matvec in
// float32 (elem 4) or float64 (elem 8): after a launch, the bytes it was
// launched with; -1 on an error.
int ldu_lane_kernel_smem(int kernel, int elem) {
#ifdef LDU_HAS_F32
  if (elem == 4) return lane_kernel_smem<float>(kernel);
#endif
#ifdef LDU_HAS_F64
  if (elem == 8) return lane_kernel_smem<double>(kernel);
#endif
  return -1;
}

// The entry points of csrc/ldu.cu's ldu_factorize / ldu_solve (kc = 0) /
// ldu_matvec for 17 <= W <= 72, taking the schedule of
// ldu_cuda._csr(sched, lane=True) and a layout without the lane's blocks.
#ifdef LDU_HAS_F32
int ldu_lane_factorize_f32(const Sched* s, const FactLayout* ly, int B, const void* blocks,
                           void* fb, void* lu, void* ps, void* stream) {
  return lane_factorize<float>(s, ly, B, blocks, fb, lu, ps, stream);
}
int ldu_lane_solve_f32(const Sched* s, const SolveLayout* ly, int B, int k, const void* fb,
                       const void* lu, const void* ps, const void* rhs, void* out, void* stream) {
  return lane_solve<float>(s, ly, B, k, fb, lu, ps, rhs, out, stream);
}
int ldu_lane_matvec_f32(const Sched* s, int B, int k, int kc, int x_off, int smem,
                        const void* blocks, const void* x, void* out, void* stream) {
  return lane_matvec<float>(s, B, k, kc, x_off, smem, blocks, x, out, stream);
}
#endif
#ifdef LDU_HAS_F64
int ldu_lane_factorize_f64(const Sched* s, const FactLayout* ly, int B, const void* blocks,
                           void* fb, void* lu, void* ps, void* stream) {
  return lane_factorize<double>(s, ly, B, blocks, fb, lu, ps, stream);
}
int ldu_lane_solve_f64(const Sched* s, const SolveLayout* ly, int B, int k, const void* fb,
                       const void* lu, const void* ps, const void* rhs, void* out, void* stream) {
  return lane_solve<double>(s, ly, B, k, fb, lu, ps, rhs, out, stream);
}
int ldu_lane_matvec_f64(const Sched* s, int B, int k, int kc, int x_off, int smem,
                        const void* blocks, const void* x, void* out, void* stream) {
  return lane_matvec<double>(s, B, k, kc, x_off, smem, blocks, x, out, stream);
}
#endif

}  // extern "C"
