// The block-LDU kernels for a lane larger than a CTA's shared memory at
// its real rows (a lane of atlas: W = 38, N = 62, S = 244, 22 levels; one
// lane's blocks take 252 KB in float32 and 503 KB in float64 at their real
// rows, W wide, against the 227 KB a CTA can have).
//
// Built from the code of csrc/ldu.cu (included below with LDU_DEVICE_ONLY,
// so that this library holds only the kernels instantiated here):
//   fact_packed   the factorize, the lane held in shared memory at each
//                 slot's real rows and real columns (leading dimension n_b,
//                 16-byte aligned): atlas's 13,136 real entries take 51.3 KB
//                 in float32 (102.6 KB in float64) against 1.41 MB padded;
//   solve_packed  the solve, the edge blocks packed (8,088 entries), each
//                 node's LU and PS at its n x n real entries, the vectors
//                 at their real offsets (436 entries), all in shared memory;
//   matvec_real<T, true>  the matvec, reading the blocks where they lie in
//                 global memory (slot sl at sl W^2: ldu_cuda._csr(sched,
//                 lane=True)); the vectors and index arrays in shared memory.
// fact_packed and solve_packed replace the TPU's fact_kernel / solve_kernel
// (dojo_tpu/pallas_ldu.py:229, :307) for such a lane; matvec_real replaces
// matvec_kernel (:324).  What bounds them on the card is each lane's
// dependency chain, as in csrc/ldu.cu: atlas's 22 levels, two of its nodes
// 38 wide (a 38-pivot block LU and 38-row substitutions), not its bytes
// (0.042 ms at B = 64 for the factorize at real widths).  Their design:
//   - staging reads only the real entries of the assembler's W-wide
//     blocks: a 6-wide float32 row is 24 bytes at a 152-byte stride (not
//     16-byte aligned, under TMA's 16-byte box), so cp.async copies pieces
//     of 8 bytes (16 in float64 where the rows allow), all issued, then
//     one wait;
//   - the schedule (ldu_cuda._csr(sched, packed=True)) gives every block's
//     packed place and each record the leading dimension its block is read
//     with; the level code of csrc/ldu.cu takes it (its PACKED template
//     flag) in place of W;
//   - a level with nodes wider than 32 (atlas's level 0: two 38-wide feet
//     and three 6-wide bodies) factors its wide nodes up to GROUP_MAXW two
//     at once, a group of GWARPS warps each with a named barrier of its
//     own (group_lu: cta_lu's arithmetic, so that every block LU stays
//     ldu.blu_factor's bitwise), and its narrow nodes beside them in the
//     last two warps (real_lu at the level's narrow tile); a node wider
//     than GROUP_MAXW is factored by the CTA (cta_lu);
//   - levels up to 32 wide run fact_level with the blocks, LU tiles, X and
//     Schur targets in shared memory, three CTA barriers a level;
//   - fb, LU and PS are written whole at their tensor places, as the bound
//     counts them: 2.1 MB a float32 lane, over 99 % of it pad (zero,
//     identity on the diagonal blocks: the assembler's, ldu_cuda's pad
//     premise).  One SM stores ~15-22 GB/s (PERF.md §6), and its pending
//     stores hold up its shared-memory loads, so the pad goes out from a
//     CTA of its own on another SM, at once with the factorization: the
//     launch has 2 B CTAs, B + b writing lane b's pad from registers;
//     the factorizing CTA writes the real entries once at the end (13,136
//     a lane, 8 bytes a store in float32);
//   - the solve stages its factors packed (PS as LU, then in compact form)
//     and runs both passes at shared-memory latency; a wide level's nodes
//     at once, each wide node by warps and a named barrier of its own
//     (group_node_solve: wide_node_solve's steps), the narrow ones beside.
// ldu_cuda.variant picks these kernels by bytes ("packed": the lane fits a
// CTA packed; the matvec "lane").
//
// Build: as csrc/ldu.cu, into libraries of their own, one a dtype (LDU_ELEM)
// and a kernel: LDU_LANE_PART=1 (2, 3) builds only the factorize (the
// solve, the matvec) and its entry point, so that ldu_cuda.build_all
// compiles the three kernels of each dtype in nvcc processes of their own,
// all at once (float64's fact_packed takes most of the time); without it,
// all three (scripts/ldu_phase_split.py's probe).

#define LDU_DEVICE_ONLY
#include "ldu.cu"

#ifndef LDU_LANE_PART
#define LDU_LANE_PART 0
#endif
#define LANE_FACT (LDU_LANE_PART == 0 || LDU_LANE_PART == 1)
#define LANE_SOLVE (LDU_LANE_PART == 0 || LDU_LANE_PART == 2)
#define LANE_MATVEC (LDU_LANE_PART == 0 || LDU_LANE_PART == 3)

#define GWARPS 3    // warps of a group LU
#define GROWS 14    // rows of a group LU a warp holds: w + GWARPS q
#define GCOLS 2     // its columns a lane holds: l + 32 c
#define GROUP_MAXW (GWARPS * GROWS)  // the widest node a group LU takes (ldu_cuda.GROUP_MAXW)

// Barrier `id` (1, 2: a group's) over the nt threads that arrive at it.
__device__ __forceinline__ void group_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nt) : "memory");
}

// cta_lu (csrc/ldu.cu) by a group of GWARPS warps for a node of real width
// n <= GROUP_MAXW, its real n x n block D at leading dimension n (packed):
// the same row scale, pivot search (each warp's first maximum, the largest
// of them, on a tie the lowest row: the first maximum of the column, as
// ldu.blu_factor takes it), arithmetic row swap, floor, quotients and
// updates, in the same order, with thread gt of the group holding entries
// (w + GWARPS q, l + 32 c) and its barrier `bar` in place of the CTA's.
// Writes the LU into lut (row stride ld), 1 / U_kk (rd), PS in compact
// form (psc, prow); M is scratch of ldu_cuda.wide_scratch(n, ld) elements.
// Ends with the group's barrier.
template <typename T>
__device__ void group_lu(const T* D, int n, T* lut, int ld, T* rd, T* psc, int* prow, T* M,
                         int gt, int bar) {
  constexpr int NT = GWARPS * 32;
  const int w = gt / 32, l = gt % 32;
  const T tiny = pivot_floor<T>();
  T* cv = M + 2 * n * ld;  // the warps' candidates, two sets: |value|
  int* ck = reinterpret_cast<int*>(cv + 2 * GWARPS);  // and row
  for (int i = w; i < n; i += GWARPS) {  // row scale, a warp a row
    T amax = T(0);
    for (int j = l; j < n; j += 32) amax = fmax(amax, fabs(D[i * n + j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmax(amax, __shfl_xor_sync(FULL, amax, off));
    const T sc = amax > T(0) ? T(1) / amax : T(1);
    for (int j = l; j < n; j += 32) M[i * ld + j] = D[i * n + j] * sc;
    if (l == 0) {
      psc[i] = sc;
      prow[i] = i;
    }
  }
  group_sync(bar, NT);
  T m[GROWS][GCOLS];
#pragma unroll
  for (int q = 0; q < GROWS; ++q) {
#pragma unroll
    for (int c = 0; c < GCOLS; ++c)
      m[q][c] = M[min(w + GWARPS * q, n - 1) * ld + min(l + 32 * c, n - 1)];
  }
  // this warp's candidate for pivot k (column k, rows >= k), from lane k %
  // 32: rows descending, a tie taking the lower row (the first maximum)
  const auto candidate = [&](int k) {
    const int c = k / 32;
    T v = T(-1);
    int key = 0xFFFF;
#pragma unroll
    for (int q = GROWS - 1; q >= 0; --q) {
      const int i = w + GWARPS * q;
      if (i < k) break;  // warp-uniform: the rows above are done
      const T a = fabs(c == 0 ? m[q][0] : m[q][1]);
      if (i < n && a >= v) { v = a; key = i; }
    }
    if (l == k % 32) {
      cv[(k & 1) * GWARPS + w] = v;
      ck[(k & 1) * GWARPS + w] = key;
    }
  };
  candidate(0);
  group_sync(bar, NT);
  for (int k = 0; k < n; ++k) {
    const T* A = M + (k & 1) * n * ld;  // the rows after pivot k - 1
    T* Bn = M + ((k & 1) ^ 1) * n * ld;  // the rows after pivot k
    T cik[GROWS];  // column k at this warp's rows
#pragma unroll
    for (int q = 0; q < GROWS; ++q) cik[q] = A[min(w + GWARPS * q, n - 1) * ld + k];
    T v = cv[(k & 1) * GWARPS];
    int p = ck[(k & 1) * GWARPS];
#pragma unroll
    for (int u = 1; u < GWARPS; ++u) {
      const T o = cv[(k & 1) * GWARPS + u];
      const int oi = ck[(k & 1) * GWARPS + u];
      if (o > v || (o == v && oi < p)) { v = o; p = oi; }
    }
    const bool swap = p != k;
    const T tkk = A[k * ld + k], tpk = A[p * ld + k];
    T a = swap ? swap_sum(tkk, tpk) : tkk;
    a = fabs(a) > tiny ? a : (a < T(0) ? -tiny : tiny);
    const T ra = recip(a);
    T rk[GCOLS], rp[GCOLS];  // the new rows k and p at this lane's columns
#pragma unroll
    for (int c = 0; c < GCOLS; ++c) {
      const int j = min(l + 32 * c, n - 1);
      const T tk = A[k * ld + j], tp = A[p * ld + j];
      rk[c] = swap ? swap_sum(tk, tp) : tk;
      rp[c] = swap_sum(tp, tk);
    }
    if (w == k % GWARPS) {  // row k of U
#pragma unroll
      for (int c = 0; c < GCOLS; ++c) {
        const int j = l + 32 * c;
        if (j >= k && j < n) lut[k * ld + j] = j == k ? a : rk[c];
      }
    }
#pragma unroll
    for (int q = GROWS - 1; q >= 0; --q) {
      const int i = w + GWARPS * q;
      if (i <= k) break;
      if (i < n) {
        const bool at_p = i == p;
        const T f = quot(at_p ? swap_sum(tpk, tkk) : cik[q], a, ra);
        if (l == 0) lut[i * ld + k] = f;
#pragma unroll
        for (int c = 0; c < GCOLS; ++c) {
          m[q][c] = elim(at_p ? rp[c] : m[q][c], f, rk[c]);
          if (l + 32 * c < n) Bn[i * ld + l + 32 * c] = m[q][c];
        }
      }
    }
    if (k + 1 < n) candidate(k + 1);
    if (swap) {  // the multipliers of rows k and p swap too, and PS's rows
      for (int j = gt; j < k; j += NT) {
        const T x = lut[k * ld + j], y = lut[p * ld + j];
        lut[k * ld + j] = swap_sum(x, y);
        lut[p * ld + j] = swap_sum(y, x);
      }
      if (gt == 0) {
        const T sk = psc[k];
        const int r0 = prow[k];
        psc[k] = psc[p];
        prow[k] = prow[p];
        psc[p] = sk;
        prow[p] = r0;
      }
    }
    if (gt == 0) rd[k] = ra;
    group_sync(bar, NT);
  }
}

// Column c of X = D^{-1} E, E the real entries of E_{i,b} (shared, leading
// dimension ldE), for a node of real width ni <= R with its LU at row
// stride ld, by one thread: PS·E as a gather and a scale, then
// tile_solve's substitutions over ni rows in its order.  X is ni x nb
// (stride nb).  At a wide level it takes the columns of its narrow nodes,
// a thread each (x_column_warp's work a warp a column).  (In place in
// shared memory it took 36.8 µs at atlas's level 0 against 17.5 for
// x_column_warp's three rounds, and unrolled for 42 rows float64's
// library did not build within 600 s: PERF.md §6.)
template <typename T, int R>
__device__ void x_column_rows(const T* L, int ld, const T* rd, const T* psc, const int* prow,
                              const T* E, T* X, int ni, int nb, int ldE, int c) {
  T y[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int jj = min(j, ni - 1);
    const T e = psc[jj] * E[prow[jj] * ldE + c];
    y[j] = j < ni ? e : T(0);
  }
#pragma unroll
  for (int j = 0; j < R - 1; ++j) {  // forward: y_i -= L_ij y_j, j ascending
    if (j < ni - 1) {
#pragma unroll
      for (int i = j + 1; i < R; ++i)
        if (i < ni) y[i] -= L[i * ld + j] * y[j];
    }
  }
#pragma unroll
  for (int j = R - 1; j >= 0; --j) {  // backward: y_j /= U_jj, then y_i -= U_ij y_j
    if (j < ni) {
      y[j] = quot(y[j], L[j * ld + j], rd[j]);
#pragma unroll
      for (int i = 0; i < j; ++i) y[i] -= L[i * ld + j] * y[j];
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j < ni) X[j * nb + c] = y[j];
}

// Start the asynchronous copies of one block's na x nb real entries from
// global memory (rows at stride W) into its packed place (leading
// dimension nb), by nl lanes from lane l, in pieces of 16, 8 or 4 bytes:
// the widest that the rows' offsets on both sides allow.  The caller
// commits and waits.
template <typename T>
__device__ void stage_block(T* dst, const T* src, int na, int nb, int W, int l, int nl) {
  const int rb = nb * (int)sizeof(T), sb = W * (int)sizeof(T);
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(dst) |
                                reinterpret_cast<uintptr_t>(src)) | rb | sb;
  const int u = (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : 4;
  const int per = rb / u;  // pieces a row
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int p = l; p < na * per; p += nl) {
    const int i = p / per, c = (p - i * per) * u;
    __pipeline_memcpy_async(d + i * rb + c, s + i * sb + c, u);
  }
}

// The pad of a W x W output block (global, at dst): every entry but the real
// ones (i < na, j < nb), zero, on the diagonal one where `diag` (the
// assembler's pad, and the plain versions' pad of fb, LU and PS), by the 32
// lanes of a warp from lane l, walking as write_rows does (no division in
// the loop): a 16-byte vector that holds no real entry in one store, the
// pad entries of one that does each alone.  Where W^2 is not a multiple of
// the vector, each pad entry alone.
template <typename T>
__device__ void write_pad(T* dst, int W, int na, int nb, bool diag, int l, RowWalk rw) {
  using V16 = typename Vec16<T>::type;
  constexpr int V = Vec16<T>::n;
  const int WW = W * W;
  if (WW % V != 0) {
    for (int e = l; e < WW; e += 32) {
      const int i = e / W, j = e - i * W;
      if (i >= na || j >= nb) dst[e] = T(diag && i == j);
    }
    return;
  }
  int i = rw.i0, j = rw.j0;
  for (int e = V * l; e < WW; e += 32 * V) {
    T x[V];
    bool real = false;
    int ii = i, jj = j;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      x[u] = T(diag && ii == jj);
      real |= ii < na && jj < nb;
      if (++jj == W) { jj = 0; ++ii; }
    }
    if (!real) {
      V16 q;
      q.x = x[0];
      q.y = x[1];
      if constexpr (V == 4) { q.z = x[2]; q.w = x[3]; }
      *reinterpret_cast<V16*>(dst + e) = q;
    } else {
      ii = i;
      jj = j;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (ii >= na || jj >= nb) dst[e + u] = x[u];
        if (++jj == W) { jj = 0; ++ii; }
      }
    }
    i += rw.di;
    j += rw.dj;
    if (j >= W) { j -= W; ++i; }
  }
}

// The real entries (i < na, j < nb) of a W x W output block (global, at
// dst), real(i, j), by the 32 lanes of a warp: two entries a store where
// the rows allow it (8 bytes in float32), else one; the pad CTA writes the
// rest (write_pad).
template <typename T, typename R>
__device__ void write_real(T* dst, int W, int na, int nb, int l, R real) {
  if constexpr (sizeof(T) == 4) {
    if (((nb | W) & 1) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
      const int half = nb / 2;
      for (int t = l; t < na * half; t += 32) {
        const int i = t / half, j = 2 * (t - i * half);
        float2 q;
        q.x = real(i, j);
        q.y = real(i, j + 1);
        *reinterpret_cast<float2*>(dst + i * W + j) = q;
      }
      return;
    }
  }
  for (int t = l; t < na * nb; t += 32) {
    const int i = t / nb, j = t - i * nb;
    dst[i * W + j] = real(i, j);
  }
}

// Output block b of a lane (fb's S slots, then each node's LU and PS):
// its place, real rows and columns, and whether its pad has a diagonal.
template <typename T>
struct OutBlock {
  T* dst;
  int na, nb;
  bool diag;
};
template <typename T>
__device__ __forceinline__ OutBlock<T> out_block(const Sched& s, const int* si, T* fbl, T* LUg,
                                                 T* PSg, int b) {
  const int W = s.width, N = s.n_nodes, S = s.n_slots;
  if (b < S) {
    const int rc = SH(slot_rc)[b];
    return {fbl + (size_t)b * W * W, rc >> 8, rc & 255, b < N};
  }
  const int nd = (b - S) >> 1, n = SH(node_w)[nd];
  return {((b - S) & 1 ? PSg : LUg) + (size_t)nd * W * W, n, n, true};
}

// The pad of a lane's outputs, blocks b = b0, b0 + nw, ... (fb's S slots,
// then each node's LU and PS), by one warp.
template <typename T>
__device__ void write_pads(const Sched& s, const int* si, T* fbl, T* LUg, T* PSg, int b0, int nw,
                           int l, RowWalk rw) {
  for (int b = b0; b < s.n_slots + 2 * s.n_nodes; b += nw) {
    const OutBlock<T> o = out_block(s, si, fbl, LUg, PSg, b);
    write_pad(o.dst, s.width, o.na, o.nb, o.diag, l, rw);
  }
}

// The k-th node up to 32 wide of the level's nodes q0..q1-1 (q1 if none).
__device__ __forceinline__ int narrow_node(const Sched& s, const int* si, int q0, int q1, int k) {
  for (int q = q0; q < q1; ++q)
    if (SH(node_w)[SH(level_nodes)[q]] <= 32 && k-- == 0) return q;
  return q1;
}

// The next position >= q of the level's nodes wider than 32 and up to
// GROUP_MAXW (q1 if none).
__device__ __forceinline__ int next_group_node(const Sched& s, const int* si, int q, int q1) {
  for (; q < q1; ++q) {
    const int n = SH(node_w)[SH(level_nodes)[q]];
    if (n > 32 && n <= GROUP_MAXW) return q;
  }
  return q1;
}

// The block LUs of the narrow nodes (up to 32 wide) of a wide level at
// tile TW, groups of G lanes, by warps w0.. of nwarps (PER nodes a warp:
// fact_level's first phase over those nodes).
template <typename T, int TW, int G>
__device__ void narrow_lus(const Sched& s, const int* si, int q0, int q1, int nnarrow, T* F,
                           T* LUt, T* rd, T* psc, int* prow, int wi, int nwarps) {
  constexpr int PER = 32 / G;
  const int g = (threadIdx.x % 32) / G, r = threadIdx.x % G;
  for (int k0 = PER * wi; k0 < nnarrow; k0 += PER * nwarps) {
    const bool live = k0 + g < nnarrow;
    const int nd = SH(level_nodes)[narrow_node(s, si, q0, q1, live ? k0 + g : k0)];
    const int nw = SH(node_w)[nd];
    const int n = __reduce_max_sync(FULL, nw);  // the warp's widest node
    const int tv = SH(node_tvec)[nd];
    real_lu<T, TW, G>(F + SH(slot_off)[nd], nw, nw, LUt + SH(node_tile)[nd], rd + tv, psc + tv,
                      prow + tv, n, r, live);
  }
}

// One factorize level with a node wider than 32, packed (level_tw: the
// narrow tile << 8 | the widest | 1): (1) the block LUs in rounds, each
// round's nodes up to GROUP_MAXW two at once, a group LU each in warps
// 0..2 and 3..5, and in the first round the narrow nodes beside them in
// warps 6 and 7 (a CTA barrier after each round); a node wider than
// GROUP_MAXW by the CTA (cta_lu); (2) the X columns, a thread each for a
// node up to 8 wide (x_column_rows), else a warp each (x_column_warp);
// (3) the target entries a thread each; a CTA barrier after (2) and (3).
// Each node's LU row stride is node_tvec[n + 1] - node_tvec[n] (pair_rec's
// ld field).  In a -DLDU_PHASES build level 0 stamps PROBE + 0 as its group
// LUs end and PROBE + 1 as its narrow LUs end.
template <typename T>
__device__ void packed_wide_level(const Sched& s, const int* si, int lv, int tw, T* F, T* LUt,
                                  T* X, T* rd, T* psc, int* prow) {
  const int w = threadIdx.x / 32;
  const int q0 = SH(level_ptr)[lv], q1 = SH(level_ptr)[lv + 1];
  int nnarrow = 0;
  for (int q = q0; q < q1; ++q) nnarrow += SH(node_w)[SH(level_nodes)[q]] <= 32;
  int qa = next_group_node(s, si, q0, q1);
  for (bool first = true; first || qa < q1; first = false) {
    const int qb = qa < q1 ? next_group_node(s, si, qa + 1, q1) : q1;
    if (w < 2 * GWARPS) {
      const int q = w < GWARPS ? qa : qb;
      if (q < q1) {
        const int nd = SH(level_nodes)[q], n = SH(node_w)[nd], tv = SH(node_tvec)[nd];
        const int ld = SH(node_tvec)[nd + 1] - tv;
        // the second group's scratch after the first's
        int m0 = 0;
        if (w >= GWARPS) {
          const int na = SH(node_w)[SH(level_nodes)[qa]], nda = SH(level_nodes)[qa];
          m0 = 2 * na * (SH(node_tvec)[nda + 1] - SH(node_tvec)[nda]) + 32;
        }
        group_lu<T>(F + SH(slot_off)[nd], n, LUt + SH(node_tile)[nd], ld, rd + tv, psc + tv,
                    prow + tv, X + m0, threadIdx.x % (GWARPS * 32), 1 + (w >= GWARPS));
        if (first && lv == 0) STAMP(PROBE + 0);
      }
    } else if (first) {
      const int wi = w - 2 * GWARPS, nwarps = CTA_WARPS - 2 * GWARPS;
      switch (tw >> 8) {
        case 8:
          narrow_lus<T, 8, 8>(s, si, q0, q1, nnarrow, F, LUt, rd, psc, prow, wi, nwarps);
          break;
        case 16:
          narrow_lus<T, 16, 16>(s, si, q0, q1, nnarrow, F, LUt, rd, psc, prow, wi, nwarps);
          break;
        case 24:
          narrow_lus<T, 24, 32>(s, si, q0, q1, nnarrow, F, LUt, rd, psc, prow, wi, nwarps);
          break;
        default:
          narrow_lus<T, 32, 32>(s, si, q0, q1, nnarrow, F, LUt, rd, psc, prow, wi, nwarps);
          break;
      }
      if (lv == 0) STAMP(PROBE + 1);
    }
    __syncthreads();
    qa = qb < q1 ? next_group_node(s, si, qb + 1, q1) : q1;
  }
  for (int q = q0; q < q1; ++q) {  // a node wider than GROUP_MAXW by the CTA
    const int nd = SH(level_nodes)[q], n = SH(node_w)[nd], tv = SH(node_tvec)[nd];
    if (n > GROUP_MAXW)
      cta_lu<T>(F + SH(slot_off)[nd], n, n, LUt + SH(node_tile)[nd], SH(node_tvec)[nd + 1] - tv,
                rd + tv, psc + tv, prow + tv, X);
  }
  STAMP(3 + 6 * lv);
  STAMP(4 + 6 * lv);
  const int p0 = SH(pair_ptr)[lv];
  for (int e = SH(xtask_ptr)[lv] + threadIdx.x; e < SH(xtask_ptr)[lv + 1]; e += NTHREADS) {
    const int task = SH(xtask)[e];
    const int* p = SH(pair_rec) + 5 * (p0 + (task >> 7));
    const int ni = (p[1] >> 8) & 255, nb = p[1] & 255;
    if (ni <= 8)
      x_column_rows<T, 8>(LUt + p[2], p[1] >> 16, rd + p[3], psc + p[3], prow + p[3], F + p[0],
                          X + p[4], ni, nb, nb, task & 127);
  }
  for (int e = SH(xtask_ptr)[lv] + w; e < SH(xtask_ptr)[lv + 1]; e += CTA_WARPS) {
    const int task = SH(xtask)[e];
    const int* p = SH(pair_rec) + 5 * (p0 + (task >> 7));
    const int ni = (p[1] >> 8) & 255, nb = p[1] & 255;
    if (ni > 8)
      x_column_warp<T>(LUt + p[2], p[1] >> 16, rd + p[3], psc + p[3], prow + p[3], F + p[0],
                       X + p[4], ni, nb, nb, task & 127, threadIdx.x % 32);
  }
  STAMP(5 + 6 * lv);
  __syncthreads();
  STAMP(6 + 6 * lv);
  const int t0 = SH(tgt_ptr)[lv];
  for (int e = SH(stask_ptr)[lv] + threadIdx.x; e < SH(stask_ptr)[lv + 1]; e += NTHREADS) {
    const int task = SH(stask)[e], t = t0 + (task >> 14);
    schur_entry<T, true>(SH(tgt_rec) + 2 * t, SH(upd_rec), SH(tgt_uptr)[t], SH(tgt_uptr)[t + 1],
                         (task >> 7) & 127, task & 127, F, X, s.width);
  }
  STAMP(7 + 6 * lv);
  __syncthreads();
  STAMP(8 + 6 * lv);
}

// The packed factorize (see the top of this file), 2 nl CTAs for nl
// lanes: CTA b < nl factors lane b and writes the real entries of its
// outputs; CTA nl + b writes lane b's pad (every other entry), on an SM of
// its own, at once.  The schedule is staged in
// shared memory where the layout has room for it (ly.si >= 0), else read
// from global memory (float64 atlas: 28 KB over).
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
fact_packed(Sched s, FactLayout ly, int nl, const T* __restrict__ blocks, T* __restrict__ fb,
            T* __restrict__ lu, T* __restrict__ ps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* F = reinterpret_cast<T*>(smem + ly.fb);
  T* LUt = reinterpret_cast<T*>(smem + ly.lu);
  T* X = reinterpret_cast<T*>(smem + ly.x);
  T* rd = reinterpret_cast<T*>(smem + ly.rd);
  T* psc = reinterpret_cast<T*>(smem + ly.psc);
  int* prow = reinterpret_cast<int*>(smem + ly.prow);
  const int* si = ly.si >= 0 ? reinterpret_cast<const int*>(smem + ly.si) : s.buf;
  const int W = s.width, WW = W * W, N = s.n_nodes, S = s.n_slots;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, NW = NTHREADS / 32;
  constexpr int V = Vec16<T>::n;
  RowWalk rw;
  rw.i0 = V * l / W;
  rw.j0 = V * l - rw.i0 * W;
  rw.di = 32 * V / W;
  rw.dj = 32 * V - rw.di * W;
  if (blockIdx.x >= (unsigned)nl) {  // a pad CTA, a warp a block (the schedule in global memory)
    const size_t pl = blockIdx.x - nl;
    write_pads(s, s.buf, fb + pl * S * WW, lu + pl * N * WW, ps + pl * N * WW, w, NW, l, rw);
    return;
  }
  const size_t lane = blockIdx.x;
  STAMP(0);
  if (ly.si >= 0) stage(reinterpret_cast<int*>(smem + ly.si), s.buf, s.buf_len);
  // each slot's real entries, a warp per slot; lane l of warp w reads the
  // place of slot w + NW l from global memory, all at once
  const T* bl = blocks + lane * S * WW;
  for (int s0 = w; s0 < S; s0 += NW * 32) {
    const int mine = s0 + NW * l;
    const int off = mine < S ? s.slot_off[mine] : 0, rc = mine < S ? s.slot_rc[mine] : 0;
    if (s0 == w) STAMP_AFTER(SUB + 0, off + rc);
    for (int k = 0; k < 32 && s0 + NW * k < S; ++k) {
      const int o = __shfl_sync(FULL, off, k), d = __shfl_sync(FULL, rc, k);
      stage_block(F + o, bl + (size_t)(s0 + NW * k) * WW, d >> 8, d & 255, W, l, 32);
    }
  }
  STAMP(SUB + 1);
  __pipeline_commit();
  T* fbl = fb + lane * S * WW;
  T* LUg = lu + lane * N * WW;
  T* PSg = ps + lane * N * WW;
  __pipeline_wait_prior(0);
  STAMP(SUB + 2);
  __syncthreads();
  STAMP(1);
  for (int lv = 0; lv < s.n_levels; ++lv) {
    const int tw = SH(level_tw)[lv];
    if ((tw & 255) > 32) {
      packed_wide_level<T>(s, si, lv, tw, F, LUt, X, rd, psc, prow);
      continue;
    }
    switch (tw) {
      case 8: fact_level<T, 8, 8, true>(s, si, lv, F, LUt, X, rd, psc, prow); break;
      case 16: fact_level<T, 16, 16, true>(s, si, lv, F, LUt, X, rd, psc, prow); break;
      case 24: fact_level<T, 24, 32, true>(s, si, lv, F, LUt, X, rd, psc, prow); break;
      default: fact_level<T, 32, 32, true>(s, si, lv, F, LUt, X, rd, psc, prow); break;
    }
  }
  // the real parts, a warp a block: fb's S slots, then each node's LU (from
  // its tile) and PS (from psc and prow)
  for (int b = w; b < S + 2 * N; b += NW) {
    if (b < S) {
      const int rc = SH(slot_rc)[b], nb = rc & 255;
      const T* src = F + SH(slot_off)[b];
      write_real(fbl + (size_t)b * WW, W, rc >> 8, nb, l,
                 [=](int i, int j) { return src[i * nb + j]; });
    } else {
      const int nd = (b - S) >> 1, n = SH(node_w)[nd], tv = SH(node_tvec)[nd];
      const int ld = SH(node_tvec)[nd + 1] - tv;
      const T* t = LUt + SH(node_tile)[nd];
      const T* pc = psc + tv;
      const int* pr = prow + tv;
      if ((b - S) & 1)
        write_real(PSg + (size_t)nd * WW, W, n, n, l,
                   [=](int i, int j) { return j == pr[i] ? pc[i] : T(0); });
      else
        write_real(LUg + (size_t)nd * WW, W, n, n, l,
                   [=](int i, int j) { return t[i * ld + j]; });
    }
  }
  STAMP(SUB + 4);
  STAMP(3 + 6 * s.n_levels);
}

// wide_node_solve (csrc/ldu.cu) for one node of real width n, its LU at
// row stride ld, by the nt threads of a group, thread r of it holding v_r
// (nt a multiple of 32), with its own barrier `bar`: the same steps in
// ldu.blu_solve's order, a barrier a row.
template <typename T>
__device__ void group_node_solve(const T* L, const T* rd, const int* prow, const T* psc, T v,
                                 T* dst, int n, int ld, int r, int nt, int bar) {
  if (r < n) dst[r] = v;
  group_sync(bar, nt);
  T y = r < n ? psc[r] * dst[prow[r]] : T(0);
  group_sync(bar, nt);
  if (r < n) dst[r] = y;
  group_sync(bar, nt);
  for (int j = 0; j < n - 1; ++j) {  // forward: y_i -= L_ij y_j, j ascending
    const T yj = dst[j];
    if (r > j && r < n) y -= L[r * ld + j] * yj;
    if (r == j + 1) dst[r] = y;
    group_sync(bar, nt);
  }
  for (int j = n - 1; j >= 0; --j) {  // backward: y_j /= U_jj, then y_i -= U_ij y_j
    if (r == j) dst[r] = y = quot(y, L[j * ld + j], rd[j]);
    group_sync(bar, nt);
    const T xj = dst[j];
    if (r < j) y -= L[r * ld + j] * xj;
  }
}

// The narrow nodes (up to 32 wide) of a wide level's solve pass at tile TW,
// groups of G lanes, by warps wi.. of nwarps: solve_level's work for each
// (its edges pulled in list order, then group_solve).
template <typename T, int TW, int G, bool FWD>
__device__ void narrow_solves(const Sched& s, const int* si, int q0, int q1, int nnarrow,
                              const T* E, const T* LUc, const T* rd, const T* psc,
                              const int* prow, T* bv, T* tv, T* xv, int wi, int nwarps) {
  constexpr int PER = 32 / G;
  const int g = (threadIdx.x % 32) / G, r = threadIdx.x % G;
  const int* ptr = FWD ? SH(fin_ptr) : SH(bin_ptr);
  const int* rec = FWD ? SH(fin_rec) : SH(bin_rec);
  const T* src = FWD ? tv : xv;
  for (int k0 = PER * wi; k0 < nnarrow; k0 += PER * nwarps) {
    const bool live = k0 + g < nnarrow;
    const int nd = SH(level_nodes)[narrow_node(s, si, q0, q1, live ? k0 + g : k0)];
    const int nw = SH(node_w)[nd], vo = SH(node_vec)[nd], lo = SH(node_lu)[nd];
    const bool out = !FWD || SH(fwd_out)[nd];
    T v = bv[vo + min(r, nw - 1)];
    for (int k = ptr[nd]; k < ptr[nd + 1]; ++k) {
      const int* e = rec + 3 * k;
      v -= row_dot_any<T, true>(E + e[0], src + e[1], e[2], r, nw, e[2]);
    }
    if (FWD && live && r < nw) bv[vo + r] = v;
    if (__any_sync(FULL, out))  // every group of the warp, or none
      group_solve<T, TW, G>(LUc + lo, rd + vo, prow + vo, psc + vo, v, (FWD ? tv : xv) + vo,
                            nw, nw, r, live && out);
  }
}

// One solve level pass with a node wider than 32, packed: every node of the
// level at once, each wide node by ceil(n / 32) warps of its own (thread r
// its row r; group_node_solve with barrier 1, 2, ...), the narrow nodes in
// the warps after them (narrow_solves at the level's narrow tile); where
// the wide nodes need more warps than the CTA has, wide_solve_level (one
// node at a time).  Then one CTA barrier.
template <typename T, bool FWD>
__device__ void packed_wide_solve_level(const Sched& s, const int* si, int lv, int pass,
                                        const T* E, const T* LUc, const T* rd, const T* psc,
                                        const int* prow, T* bv, T* tv, T* xv) {
  const int w = threadIdx.x / 32;
  const int q0 = SH(level_ptr)[lv], q1 = SH(level_ptr)[lv + 1];
  int nwide = 0, nnarrow = 0, narrow_w = 0;
  for (int q = q0; q < q1; ++q) {
    const int n = SH(node_w)[SH(level_nodes)[q]];
    if (n > 32) nwide += (n + 31) / 32;
    else { ++nnarrow; narrow_w = max(narrow_w, n); }
  }
  if (nwide + (nnarrow > 0) > CTA_WARPS) {
    wide_solve_level<T, FWD, true>(s, si, lv, pass, E, LUc, rd, psc, prow, bv, tv, xv);
    return;
  }
  const int* ptr = FWD ? SH(fin_ptr) : SH(bin_ptr);
  const int* rec = FWD ? SH(fin_rec) : SH(bin_rec);
  const T* src = FWD ? tv : xv;
  int w0 = 0, bar = 1;
  for (int q = q0; q < q1; ++q) {
    const int nd = SH(level_nodes)[q], n = SH(node_w)[nd];
    if (n <= 32) continue;
    const int nwp = (n + 31) / 32;
    if (w >= w0 && w < w0 + nwp) {
      const int r = threadIdx.x - 32 * w0, vo = SH(node_vec)[nd], lo = SH(node_lu)[nd];
      T v = bv[vo + min(r, n - 1)];
      for (int k = ptr[nd]; r < n && k < ptr[nd + 1]; ++k) {
        const int* e = rec + 3 * k;
        v -= row_dot_any<T, true>(E + e[0], src + e[1], e[2], r, n, e[2]);
      }
      STAMP(3 + 3 * pass);
      if (FWD && r < n) bv[vo + r] = v;
      if (!FWD || SH(fwd_out)[nd])
        group_node_solve<T>(LUc + lo, rd + vo, prow + vo, psc + vo, v, (FWD ? tv : xv) + vo, n,
                            n, r, 32 * nwp, bar);
    }
    w0 += nwp;
    ++bar;
  }
  if (w >= w0 && nnarrow > 0) {
    if (level_tile(narrow_w) == 8)
      narrow_solves<T, 8, 8, FWD>(s, si, q0, q1, nnarrow, E, LUc, rd, psc, prow, bv, tv, xv,
                                  w - w0, CTA_WARPS - w0);
    else
      narrow_solves<T, 32, 32, FWD>(s, si, q0, q1, nnarrow, E, LUc, rd, psc, prow, bv, tv, xv,
                                    w - w0, CTA_WARPS - w0);
  }
  STAMP(4 + 3 * pass);
  __syncthreads();
  STAMP(5 + 3 * pass);
}

// One packed solve level pass: a level with a node wider than 32 by
// packed_wide_solve_level, a narrower one by solve_level at tile 8 or 32.
template <typename T, bool FWD>
__device__ void packed_solve_pass(const Sched& s, const int* si, int lv, int pass, const T* E,
                                  const T* LUc, const T* rd, const T* psc, const int* prow,
                                  T* bv, T* tv, T* xv) {
  const int w = SH(level_w)[lv];
  if (w > 32)
    packed_wide_solve_level<T, FWD>(s, si, lv, pass, E, LUc, rd, psc, prow, bv, tv, xv);
  else if (level_tile(w) == 8)
    solve_level<T, 8, 8, true, FWD, true>(s, si, lv, pass, E, LUc, rd, psc, prow, bv, tv, xv);
  else
    solve_level<T, 32, 32, true, FWD, true>(s, si, lv, pass, E, LUc, rd, psc, prow, bv, tv, xv);
}

// The packed solve (see the top of this file): one CTA a right-hand side,
// reading the factors of lane blockIdx.x / k.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, (sizeof(T) == 4 ? 2 : 1))
solve_packed(Sched s, SolveLayout ly, int k, const T* __restrict__ fb, const T* __restrict__ lu,
             const T* __restrict__ ps, const T* __restrict__ rhs, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t fl = blockIdx.x / (unsigned)k;  // the lane of the factors
  T* E = reinterpret_cast<T*>(smem + ly.e);  // edge slot sl at slot_off[sl] - slot_off[N]
  T* LUc = reinterpret_cast<T*>(smem + ly.lu);  // node n's n x n LU at node_lu[n]
  T* rd = reinterpret_cast<T*>(smem + ly.rd);
  T* psc = reinterpret_cast<T*>(smem + ly.psc);
  T* bv = reinterpret_cast<T*>(smem + ly.b);  // node n's vectors at node_vec[n]
  T* tv = reinterpret_cast<T*>(smem + ly.t);
  T* xv = reinterpret_cast<T*>(smem + ly.x);
  T* PSc = reinterpret_cast<T*>(smem + ly.ps);  // node n's n x n PS at node_lu[n]
  int* prow = reinterpret_cast<int*>(smem + ly.prow);
  int* si = reinterpret_cast<int*>(smem + ly.si);
  const int W = s.width, N = s.n_nodes, S = s.n_slots, WW = W * W;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, NW = NTHREADS / 32;
  const size_t lane = blockIdx.x;
  STAMP(0);
  stage(si, s.buf, s.buf_len);
  // the edge blocks packed (a warp per slot), each node's LU at its real
  // entries and its right-hand side at its real offset (a warp per node);
  // lane l of warp w reads the places of edge slot N + w + NW l and node
  // w + NW l from global memory, all at once
  const T* Eg = fb + fl * S * WW;
  const T* b0 = rhs + lane * N * W;
  const int e0 = s.slot_off[N];
  for (int s0 = N + w, n0 = w; s0 < S || n0 < N; s0 += NW * 32, n0 += NW * 32) {
    const int se = s0 + NW * l, ne = n0 + NW * l;
    const int off = se < S ? s.slot_off[se] : 0, rc = se < S ? s.slot_rc[se] : 0;
    const int noff = ne < N ? s.node_lu[ne] : 0, nw = ne < N ? s.node_w[ne] : 0;
    const int nvo = ne < N ? s.node_vec[ne] : 0;
    if (n0 == w) STAMP_AFTER(SUB + 0, off + rc + noff + nw + nvo);
    for (int q = 0; q < 32 && s0 + NW * q < S; ++q) {
      const int o = __shfl_sync(FULL, off, q) - e0, d = __shfl_sync(FULL, rc, q);
      stage_block(E + o, Eg + (size_t)(s0 + NW * q) * WW, d >> 8, d & 255, W, l, 32);
    }
    for (int q = 0; q < 32 && n0 + NW * q < N; ++q) {
      const int o = __shfl_sync(FULL, noff, q), n = __shfl_sync(FULL, nw, q);
      const int vo = __shfl_sync(FULL, nvo, q), nd = n0 + NW * q;
      stage_block(LUc + o, lu + (fl * N + nd) * WW, n, n, W, l, 32);
      stage_block(PSc + o, ps + (fl * N + nd) * WW, n, n, W, l, 32);
      for (int r = l; r < n; r += 32)
        __pipeline_memcpy_async(bv + vo + r, b0 + nd * W + r, sizeof(T));
    }
  }
  STAMP(SUB + 1);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  STAMP(SUB + 2);
  __syncthreads();
  // PS in compact form and 1 / diag(U), a warp per node, a lane per row (a
  // node wider than 32 by its warp, a lane a row of each 32)
  for (int nd = w; nd < N; nd += NW) {
    const int nw = SH(node_w)[nd], vo = SH(node_vec)[nd], lo = SH(node_lu)[nd];
    for (int i = l; i < nw; i += 32) {
      int src;
      T scale;
      if (nw > 32) {
        ps_row_n(PSc + lo, nw, nw, i, src, scale);
      } else {
        switch (level_tile(nw)) {
          case 8: ps_row<T, 8>(PSc + lo, nw, nw, i, src, scale); break;
          case 16: ps_row<T, 16>(PSc + lo, nw, nw, i, src, scale); break;
          case 24: ps_row<T, 24>(PSc + lo, nw, nw, i, src, scale); break;
          default: ps_row<T, 32>(PSc + lo, nw, nw, i, src, scale); break;
        }
      }
      prow[vo + i] = src;
      psc[vo + i] = scale;
      rd[vo + i] = T(1) / LUc[lo + i * nw + i];
    }
  }
  STAMP(SUB + 3);
  __syncthreads();
  STAMP(1);
  for (int lv = 0; lv < s.n_levels; ++lv)
    packed_solve_pass<T, true>(s, si, lv, lv, E, LUc, rd, psc, prow, bv, tv, xv);
  for (int lv = s.n_levels - 1; lv >= 0; --lv)
    packed_solve_pass<T, false>(s, si, lv, 2 * s.n_levels - 1 - lv, E, LUc, rd, psc, prow, bv,
                                tv, xv);
  for (int e = threadIdx.x; e < N * W; e += NTHREADS) {  // the pad passes b through
    const int nd = e / W, r = e - nd * W;
    out[lane * N * W + e] = r < SH(node_w)[nd] ? xv[SH(node_vec)[nd] + r] : b0[e];
  }
  STAMP(3 + 6 * s.n_levels);
}

template <typename T>
static int packed_factorize(const Sched* s, const FactLayout* ly, int B, const void* blocks,
                            void* fb, void* lu, void* ps, void* stream) {
  static int last[MAX_DEVICES];
  return launch(fact_packed<T>, last, true, 2 * B, NTHREADS, ly->bytes, stream, *s, *ly, B,
                (const T*)blocks, (T*)fb, (T*)lu, (T*)ps);
}

template <typename T>
static int packed_solve(const Sched* s, const SolveLayout* ly, int B, int k, const void* fb,
                        const void* lu, const void* ps, const void* rhs, void* out,
                        void* stream) {
  static int last[MAX_DEVICES];
  return launch(solve_packed<T>, last, true, B * k, NTHREADS, ly->bytes, stream, *s, *ly, k,
                (const T*)fb, (const T*)lu, (const T*)ps, (const T*)rhs, (T*)out);
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
  cudaError_t e = cudaErrorInvalidValue;
#if LANE_FACT
  if (kernel == 0) e = cudaFuncGetAttributes(&a, fact_packed<T>);
#endif
#if LANE_SOLVE
  if (kernel == 1) e = cudaFuncGetAttributes(&a, solve_packed<T>);
#endif
#if LANE_MATVEC
  if (kernel == 2) e = cudaFuncGetAttributes(&a, matvec_real<T, true>);
#endif
  return e == cudaSuccess ? a.maxDynamicSharedSizeBytes : -1;
}

extern "C" {

int ldu_lane_max_width() { return WIDE_MAXW; }
int ldu_lane_group_maxw() { return GROUP_MAXW; }

// The dynamic shared-memory cap of kernel 0 factorize (packed), 1 solve
// (packed), 2 matvec (lane) in float32 (elem 4) or float64 (elem 8): after
// a launch, the bytes it was launched with; -1 on an error or for a kernel
// this library was not built with (LDU_LANE_PART).
int ldu_lane_kernel_smem(int kernel, int elem) {
#ifdef LDU_HAS_F32
  if (elem == 4) return lane_kernel_smem<float>(kernel);
#endif
#ifdef LDU_HAS_F64
  if (elem == 8) return lane_kernel_smem<double>(kernel);
#endif
  return -1;
}

// The entry points of csrc/ldu.cu's ldu_factorize / ldu_solve (kc = 0) for
// 17 <= W <= 72, taking the schedule of ldu_cuda._csr(sched, packed=True),
// and ldu_matvec, taking that of ldu_cuda._csr(sched, lane=True).
#ifdef LDU_HAS_F32
#if LANE_FACT
int ldu_packed_factorize_f32(const Sched* s, const FactLayout* ly, int B, const void* blocks,
                             void* fb, void* lu, void* ps, void* stream) {
  return packed_factorize<float>(s, ly, B, blocks, fb, lu, ps, stream);
}
#endif
#if LANE_SOLVE
int ldu_packed_solve_f32(const Sched* s, const SolveLayout* ly, int B, int k, const void* fb,
                         const void* lu, const void* ps, const void* rhs, void* out,
                         void* stream) {
  return packed_solve<float>(s, ly, B, k, fb, lu, ps, rhs, out, stream);
}
#endif
#if LANE_MATVEC
int ldu_lane_matvec_f32(const Sched* s, int B, int k, int kc, int x_off, int smem,
                        const void* blocks, const void* x, void* out, void* stream) {
  return lane_matvec<float>(s, B, k, kc, x_off, smem, blocks, x, out, stream);
}
#endif
#endif
#ifdef LDU_HAS_F64
#if LANE_FACT
int ldu_packed_factorize_f64(const Sched* s, const FactLayout* ly, int B, const void* blocks,
                             void* fb, void* lu, void* ps, void* stream) {
  return packed_factorize<double>(s, ly, B, blocks, fb, lu, ps, stream);
}
#endif
#if LANE_SOLVE
int ldu_packed_solve_f64(const Sched* s, const SolveLayout* ly, int B, int k, const void* fb,
                         const void* lu, const void* ps, const void* rhs, void* out,
                         void* stream) {
  return packed_solve<double>(s, ly, B, k, fb, lu, ps, rhs, out, stream);
}
#endif
#if LANE_MATVEC
int ldu_lane_matvec_f64(const Sched* s, int B, int k, int kc, int x_off, int smem,
                        const void* blocks, const void* x, void* out, void* stream) {
  return lane_matvec<double>(s, B, k, kc, x_off, smem, blocks, x, out, stream);
}
#endif
#endif

}  // extern "C"
