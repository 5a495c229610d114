// K15: decode attention over a paged KV pool.
//
// Replaces the Pallas kernel of whisper_apr_tpu/ops/paged_attention.py
// (_paged_attn_kernel / paged_attention_stacked, pallas_call at :115):
// one query row per slot attends to that slot's history, which lives in
// 16-row pages of a pool shared by every slot and is found through the
// slot's page table. Per head h and slot b:
//
//   s[t] = sum_d k[t, d] * (q[d] * hd^-0.5)     (f32, d in head h)
//   out  = sum_t softmax(s)[t] * v[t]           (f32, cast to q's dtype)
//
// over rows t < n = min(lengths[b], 16 * P), row t in page
// tables[b, t / 16] at offset t % 16 of pool[layer]. As in the JAX kernel,
// a slot with no valid row (lengths[b] <= 0) scores every row of its P
// pages -0.7 * f32max (its output is the mean of those rows' V), and the
// softmax sum is clamped to 1e-30. Page ids are clamped into the pool
// (the JAX gather clamps out-of-range indices).
//
// Bound: the bytes of the K and V rows read (2 * n * D * elem per slot),
// far below the compute rate; at the serving tick's few slots a call
// moves well under a microsecond of them, so what sets the time is the
// chain of dependent steps from the first load to the last store, and
// how many SMs share the longest slot's rows.
//
// Design: grid (R, B, G), 256 threads a block, clusters of the R blocks
// of one (slot, head group). Block (r, b, g) takes the run of pages
// [r run, (r + 1) run) of slot b's table and the Hg = H / G heads of group
// g (ops/paged_attention.paged_plan chooses run and G from the host's
// shapes alone; `lengths` is read on the device only). It reads the
// slot's length and the run's page ids at once, then copies the rows
// below the slot's length of the group's columns into shared memory,
// every copy in flight together (cp.async, a thread keeping one 16-byte
// column piece). Then, over all of the run's rows at once: every (row,
// head) score, two lanes a score, each reading 16-byte pieces of K and q
// in an order rotated by the score's index (no bank conflict); each
// head's max, weights and sum by a warp; the weighted V rows, a 16-byte
// column chunk and a group of rows a thread, the groups added in order. A
// block whose pages lie wholly past a non-empty slot's length computes
// nothing. A slot whose rows fit in one run is written out by that run's
// block. Otherwise every busy block stores its (m, l) and each rank's
// share of its columns into that rank's shared memory (st.async, counted
// by the receiver's transaction barrier), and each rank merges its share
// over the busy runs in run order: the runs' weights by a warp a head,
// the columns a quad a thread. Rows past a non-empty slot's length are
// never read, so garbage pages past it cannot reach the softmax, and every
// sum runs in a fixed order: two runs give the same bits.
#include "cluster.cuh"

namespace wa {
namespace {

constexpr float PA_NEG = -0.7f * 3.4028234663852886e38f;
constexpr int PA_PAGE = 16;
constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_MAX_HEADS = 32;
constexpr int PA_MAX_RUN = 4;          // pages a block, at most (64 rows)
constexpr int PA_MAX_CLUSTER = 16;     // runs of a slot, at most
constexpr float PA_QSCALE = 0.125f;    // HD ** -0.5

__host__ __device__ inline int pa_round16(int n) { return (n + 15) / 16 * 16; }

// the weighted V rows: Dg elem / 16 column chunks of 16 bytes times this
// many row groups over the block's threads
__host__ __device__ inline int paged_row_groups(int Dg, int elem) {
    const int chunks = Dg * elem / 16;
    return chunks >= PA_THREADS ? 1 : PA_THREADS / chunks;
}

// rank r's share of the group's Dg / 4 column quads in the merge
__host__ __device__ inline int paged_quad0(int Dg, int R, int r) {
    return r * (Dg / 4) / R;
}

// shared-memory layout of a K15 block in bytes (every offset a multiple
// of 16); Dg = 64 Hg columns of the head group, R runs a slot
struct PagedLayout {
    int k, v, q, s, red, acc, m, l, fac, rm, racc, bar, total;
};

__host__ __device__ inline PagedLayout paged_layout(int Dg, int Hg, int elem,
                                                    int run, int R) {
    PagedLayout L;
    const int share = paged_quad0(Dg, R, 1) + 1;   // most quads a rank
    int o = 0;
    L.k = o;    o += run * PA_PAGE * Dg * elem;   // [16 run][Dg]
    L.v = o;    o += run * PA_PAGE * Dg * elem;
    L.q = o;    o += pa_round16(Dg * elem);
    L.s = o;    o += pa_round16(run * PA_PAGE * Hg * 4);   // [16 run][Hg]
    L.red = o;  o += paged_row_groups(Dg, elem) * Dg * 4;
    L.acc = o;  o += Dg * 4;
    L.m = o;    o += pa_round16(Hg * 4);
    L.l = o;    o += pa_round16(Hg * 4);
    L.fac = o;  o += pa_round16(R * Hg * 4);              // [R][Hg]
    L.rm = o;   o += pa_round16(R * 2 * Hg * 4);          // [R][m, l]
    L.racc = o; o += R * share * 16;                      // [R][share]
    L.bar = o;  o += 16;
    L.total = o;
    return L;
}

// 16 bytes of a staged row as f32 (8 bf16 or 4 f32 elements)
__device__ __forceinline__ void pa_chunk(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void pa_chunk(const __nv_bfloat16* p,
                                         float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
}

// grid (R, B, G), clusters (R, 1, 1); see above
template <typename T>
__global__ void __launch_bounds__(PA_THREADS) paged_attn_kernel(
        const T* __restrict__ q, const T* __restrict__ kp,
        const T* __restrict__ vp, const int* __restrict__ tables,
        const int* __restrict__ lengths, int P, int n_pages, int D,
        int Hg, int run, T* __restrict__ out) {
    constexpr int E = (int)sizeof(T);
    constexpr int EL = 16 / E;                  // elements a 16-byte piece
    constexpr int NSTEP = 2 * E;                // pieces a lane of a score
    extern __shared__ __align__(16) unsigned char pa_smem[];
    const int r = blockIdx.x, b = blockIdx.y, g = blockIdx.z, R = gridDim.x;
    const int Dg = Hg * HD, col0 = g * Dg;
    const PagedLayout lay = paged_layout(Dg, Hg, E, run, R);
    T* k_s = reinterpret_cast<T*>(pa_smem + lay.k);
    T* v_s = reinterpret_cast<T*>(pa_smem + lay.v);
    T* q_s = reinterpret_cast<T*>(pa_smem + lay.q);
    float* s_sh = reinterpret_cast<float*>(pa_smem + lay.s);
    float* red = reinterpret_cast<float*>(pa_smem + lay.red);
    float* acc_s = reinterpret_cast<float*>(pa_smem + lay.acc);
    float* m_s = reinterpret_cast<float*>(pa_smem + lay.m);
    float* l_s = reinterpret_cast<float*>(pa_smem + lay.l);
    float* fac = reinterpret_cast<float*>(pa_smem + lay.fac);
    float* rm = reinterpret_cast<float*>(pa_smem + lay.rm);
    float* racc = reinterpret_cast<float*>(pa_smem + lay.racc);
    uint64_t* bar = reinterpret_cast<uint64_t*>(pa_smem + lay.bar);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int p0 = r * run;

    // 1. the slot's length and the run's page ids, loaded together
    int pid[PA_MAX_RUN];
#pragma unroll
    for (int i = 0; i < PA_MAX_RUN; ++i)
        pid[i] = i < run && p0 + i < P
            ? __ldg(tables + (size_t)b * P + p0 + i) : 0;
    const int cap = P * PA_PAGE;
    const int n_valid = min(max(__ldg(lengths + b), 0), cap);
    // no valid row at all: every row of the table takes part at NEG
    const int n_loop = n_valid > 0 ? n_valid : cap;
    const int pages_used = (n_loop + PA_PAGE - 1) / PA_PAGE;
    const int busy = (pages_used + run - 1) / run;     // runs holding rows
    const int nrows = min(run * PA_PAGE, n_loop - p0 * PA_PAGE);
    const bool merge = busy > 1;
    const int NQ = Dg / 4;
    const int q0 = paged_quad0(Dg, R, r), q1 = paged_quad0(Dg, R, r + 1);
    if (!merge && nrows <= 0) return;     // the slot's rows fit in run 0
    if (merge) {
        // every busy block's (m, l) and its share of this rank's columns
        // (set up before any block stores: arrive here, wait before the
        // first remote store)
        if (tid == 0) {
            mbar_init_expect(bar, busy * (2 * Hg + 4 * (q1 - q0)) * 4);
            asm volatile("fence.mbarrier_init.release.cluster;\n"
                         ::: "memory");
        }
        __syncwarp();
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                     ::: "memory");
    }

    if (nrows > 0) {
        // 2. the rows below the slot's length, K and V of the group's
        //    columns: a 16-byte piece of a row a copy, a thread keeping its
        //    piece column; then q
        const int pieces = Dg / EL;
        for (int e = tid; e < PA_PAGE * pieces; e += PA_THREADS) {
            const int c = (e % pieces) * EL;
            for (int t = e / pieces; t < nrows; t += PA_PAGE) {
                const int i = t / PA_PAGE;
                int pg = pid[0];            // pid[i], no local-memory array
#pragma unroll
                for (int j = 1; j < PA_MAX_RUN; ++j) pg = i == j ? pid[j] : pg;
                pg = min(max(pg, 0), n_pages - 1);
                const size_t src = ((size_t)pg * PA_PAGE + t % PA_PAGE) * D
                    + col0 + c;
                cp_async16(k_s + t * Dg + c, kp + src, 16);
                cp_async16(v_s + t * Dg + c, vp + src, 16);
            }
        }
        cp_async_commit();
        for (int c = tid; c < pieces; c += PA_THREADS)
            *reinterpret_cast<uint4*>(q_s + c * EL) =
                *reinterpret_cast<const uint4*>(q + (size_t)b * D + col0
                                                + c * EL);
        cp_async_wait<0>();
        __syncthreads();

        // 3. every (row, head) score of the run: two lanes a score, each
        //    over NSTEP 16-byte pieces of K and q, in an order rotated by
        //    the score's index (a warp's reads spread over all banks)
        const int lp = tid & 1;
        for (int base = 0; base < nrows * Hg; base += PA_THREADS / 2) {
            const int idx = min(base + (tid >> 1), nrows * Hg - 1);
            const int t = idx / Hg, hh = idx - t * Hg;
            const T* kr = k_s + t * Dg + hh * HD;
            const T* qr = q_s + hh * HD;
            float part[NSTEP];
#pragma unroll
            for (int k = 0; k < NSTEP; ++k) {
                const int c = (2 * ((k + idx) % NSTEP) + lp) * EL;
                float kv[EL], qv[EL];
                pa_chunk(kr + c, kv);
                pa_chunk(qr + c, qv);
                part[k] = 0.f;
#pragma unroll
                for (int j = 0; j < EL; ++j) part[k] += qv[j] * kv[j];
            }
#pragma unroll
            for (int w = NSTEP / 2; w > 0; w >>= 1)
#pragma unroll
                for (int k = 0; k < w; ++k) part[k] += part[k + w];
            const float dot =
                part[0] + __shfl_xor_sync(0xffffffffu, part[0], 1);
            if (lp == 0 && base + (tid >> 1) < nrows * Hg)
                s_sh[t * Hg + hh] = p0 * PA_PAGE + t < n_valid
                    ? dot * PA_QSCALE : PA_NEG;
        }
        __syncthreads();
        // 4. each head's max over the run's rows, its weights (in place of
        //    the scores) and their sum: a warp a head, two rows a lane
        for (int hh = warp; hh < Hg; hh += PA_WARPS) {
            const float s0 = lane < nrows ? s_sh[lane * Hg + hh] : -INFINITY;
            const float s1 = lane + 32 < nrows ? s_sh[(lane + 32) * Hg + hh]
                                               : -INFINITY;
            const float mx = warp_max(fmaxf(s0, s1));
            const float e0 = lane < nrows ? expf(s0 - mx) : 0.f;
            const float e1 = lane + 32 < nrows ? expf(s1 - mx) : 0.f;
            const float sum = warp_sum(e0 + e1);
            if (lane < nrows) s_sh[lane * Hg + hh] = e0;
            if (lane + 32 < nrows) s_sh[(lane + 32) * Hg + hh] = e1;
            if (lane == 0) {
                m_s[hh] = mx;
                l_s[hh] = sum;
            }
        }
        __syncthreads();
        // 5. the weighted V rows: a 16-byte column chunk and a row group
        //    a thread, then the row groups added in order
        const int chunks = Dg / EL, RG = paged_row_groups(Dg, E);
        for (int e = tid; e < chunks * RG; e += PA_THREADS) {
            const int ch = e % chunks, rg = e / chunks, hh = ch * EL / HD;
            float a[EL] = {};
            for (int t = rg; t < nrows; t += RG) {
                float v[EL];
                pa_chunk(v_s + t * Dg + ch * EL, v);
                const float p = s_sh[t * Hg + hh];
#pragma unroll
                for (int j = 0; j < EL; ++j) a[j] += p * v[j];
            }
#pragma unroll
            for (int j = 0; j < EL; ++j) red[rg * Dg + ch * EL + j] = a[j];
        }
        __syncthreads();
        for (int d = tid; d < Dg; d += PA_THREADS) {
            float a = 0.f;
            for (int rg = 0; rg < RG; ++rg) a += red[rg * Dg + d];
            acc_s[d] = a;
        }
        __syncthreads();
    }

    if (!merge) {                         // the slot's only run: write out
        for (int d = tid; d < Dg; d += PA_THREADS)
            out[(size_t)b * D + col0 + d] =
                from_f32<T>(acc_s[d] / fmaxf(l_s[d / HD], 1e-30f));
        return;
    }
    // 6. a busy block stores its (m, l) into every rank and each rank's
    //    share of its columns into that rank (every barrier is set up)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (nrows > 0) {
        for (int e = tid; e < R * 2 * Hg; e += PA_THREADS) {
            const int rr = e / (2 * Hg), i = e - rr * 2 * Hg;
            st_async(cluster_addr(rm + r * 2 * Hg + i, rr),
                     i < Hg ? m_s[i] : l_s[i - Hg], cluster_addr(bar, rr));
        }
        const int share = paged_quad0(Dg, R, 1) + 1;
        for (int qd = tid; qd < NQ; qd += PA_THREADS) {
            // the rank whose share holds quad qd
            const int rr = ((qd + 1) * R + NQ - 1) / NQ - 1;
            const float v[4] = {acc_s[4 * qd], acc_s[4 * qd + 1],
                                acc_s[4 * qd + 2], acc_s[4 * qd + 3]};
            st_async4(cluster_addr(racc + (r * share + qd
                                           - paged_quad0(Dg, R, rr)) * 4,
                                   rr), v, cluster_addr(bar, rr));
        }
    }
    // 7. this rank's columns over the busy runs, in run order: each run's
    //    weight exp(m - M) by a warp a head, a lane a run
    mbar_wait_bounded(bar);
    for (int hh = warp; hh < Hg; hh += PA_WARPS) {
        const float m = lane < busy ? rm[lane * 2 * Hg + hh] : -INFINITY;
        const float l = lane < busy ? rm[lane * 2 * Hg + Hg + hh] : 0.f;
        const float M = warp_max(m);
        const float f = lane < busy ? expf(m - M) : 0.f;
        const float L = warp_sum(l * f);
        if (lane < busy) fac[lane * Hg + hh] = f;
        if (lane == 0) s_sh[hh] = fmaxf(L, 1e-30f);   // l_s may be in flight
    }
    __syncthreads();
    const int share = paged_quad0(Dg, R, 1) + 1;
    for (int qd = q0 + tid; qd < q1; qd += PA_THREADS) {
        const int hh = 4 * qd / HD;
        float A[4] = {0.f, 0.f, 0.f, 0.f};
        for (int rr = 0; rr < busy; ++rr) {
            const float f = fac[rr * Hg + hh];
            const float4 a = *reinterpret_cast<const float4*>(
                racc + (rr * share + qd - q0) * 4);
            A[0] += a.x * f; A[1] += a.y * f; A[2] += a.z * f; A[3] += a.w * f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            out[(size_t)b * D + col0 + 4 * qd + j] =
                from_f32<T>(A[j] / s_sh[hh]);
    }
}

template <typename T>
int launch(const void* q, int B, int D, int H, const void* kp,
           const void* vp, int n_pages, const int* tables, int P,
           const int* lengths, int run, int G, void* out, cudaStream_t st) {
    const auto kernel = paged_attn_kernel<T>;
    const int R = (P + run - 1) / run, Hg = H / G;
    const int smem = paged_layout(Hg * HD, Hg, (int)sizeof(T), run, R).total;
    static int opted_in = 0;                // the most asked of this kernel
    if (smem > opted_in) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e == cudaSuccess && opted_in == 0)    // clusters of up to 16
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        opted_in = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R, B, G);
    cfg.blockDim = dim3(PA_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = R;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), tables, lengths, P, n_pages, D, Hg, run,
        static_cast<T*>(out));
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace
}  // namespace wa

using namespace wa;

// q [B, D] and out [B, D] in the pool's dtype (f32 or bf16); k_pool and
// v_pool point at the layer's [n_pages, 16, D] block; tables [B, P] and
// lengths [B] int32 on the device. D = H * 64. run (pages a block, at most
// 4, ceil(P / run) at most 16) and G (head groups, dividing H) come from
// ops/paged_attention.paged_plan.
extern "C" int wa_paged_attention(const void* q, int dtype, int B, int D,
                                  int H, const void* k_pool,
                                  const void* v_pool, int n_pages,
                                  const int* tables, int P,
                                  const int* lengths, void* out, int run,
                                  int groups, void* stream) {
    if (D != H * HD || H > PA_MAX_HEADS || B < 1 || P < 1 || n_pages < 1
            || run < 1 || run > PA_MAX_RUN
            || (P + run - 1) / run > PA_MAX_CLUSTER || groups < 1
            || H % groups != 0
            || ((reinterpret_cast<uintptr_t>(q)
                 | reinterpret_cast<uintptr_t>(k_pool)
                 | reinterpret_cast<uintptr_t>(v_pool)) % 16) != 0)
        return ERR_SHAPE;
    const int elem = dtype == F32 ? 4 : 2, Hg = H / groups;
    if (paged_layout(Hg * HD, Hg, elem, run, (P + run - 1) / run).total
            > 227 * 1024)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch<float>(q, B, D, H, k_pool, v_pool, n_pages, tables, P,
                             lengths, run, groups, out, st);
    if (dtype == BF16)
        return launch<__nv_bfloat16>(q, B, D, H, k_pool, v_pool, n_pages,
                                     tables, P, lengths, run, groups, out,
                                     st);
    return ERR_DTYPE;
}
