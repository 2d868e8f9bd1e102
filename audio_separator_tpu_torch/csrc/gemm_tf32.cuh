// float32 GEMM on the tensor cores as a 3xTF32 split (sm_90a), included by
// tiles.cuh: C = A·B in float32 through a run epilogue, for the float32
// launches of the fused RoFormer blocks.
//
// Hopper's tensor cores have no float32 mode, and one TF32 product keeps 10
// mantissa bits. Split each operand into a TF32 head and tail, hi = tf32(x)
// (round to nearest, ties away: add half of the 13 dropped bits and clear
// them), lo = tf32(x - hi), and sum a_hi·b_hi + a_hi·b_lo + a_lo·b_hi into
// one float32 accumulator: each term is good to about 2^-21 of its size,
// the float32 product's own level (ops/tf32.py has the plain version). At
// three products per term the bound is the TF32 rate over three,
// 494.7 / 3 = 165 TFLOP/s, against 67 for float32 on the FMA pipe.
//
// B comes prepared, once per weight tensor: (2, N, K), the heads and tails of
// Bᵀ (wgmma reads 32-bit operands K-major only; it has no transpose bit for
// them). A is split on the fly, off the consumers' path: three warps of the
// producer warpgroup, idle otherwise, round each stage's A box to its heads
// in place and write the tails beside it once TMA has brought it, and tell
// the consumers so on the stage's `ready` barrier.
//
// The pipeline is gemm_wgmma_kernel's: persistent blocks of three warpgroups
// in clusters of T_CLUSTER; a producer thread keeps a ring of T_STAGES stages
// filled by TMA (A: this block's 64 rows x 32 K as one K-major box; B heads
// and tails: 128 columns x 32 K each, of which each block of the cluster
// loads its share and multicasts it to all); the two consumer warpgroups take
// turns at 64 x 128 output tiles, m64n128k8 x 3 products a k8 step, and run
// the epilogue on the accumulator registers while the other one multiplies.
// A stage is 48 KB (A, A's tails, B's heads and tails), so four fit. The
// tensor cores' own sums cover a chain of T_CHAIN stages (128 deep); the FMA
// pipe adds those (see the consumer).

// Clusters of two fill every SM; clusters of four were slower (PERF.md).
constexpr int T_BN = 128, T_BK = 32, T_STAGES = 4, T_CLUSTER = 2, T_CHAIN = 4;
constexpr int T_A_BYTES = G_WM * T_BK * 4;  // 64 rows of 32 floats
constexpr int T_B_BYTES = T_BN * T_BK * 4;  // 128 columns of 32 floats
constexpr int T_STAGE_BYTES = 2 * T_A_BYTES + 2 * T_B_BYTES;
constexpr int T_STAGE_TX = T_A_BYTES + 2 * T_B_BYTES;  // what TMA brings in a stage
constexpr int T_SPLITTERS = 96;                         // warps 9..11 split A
constexpr uint16_t T_ALL = (1u << T_CLUSTER) - 1;       // multicast: every block
constexpr size_t GEMM_TF32_SMEM_BYTES = T_STAGES * T_STAGE_BYTES + 1024 + (3 * T_STAGES + 2) * 8;

// tf32(x): the float32 nearest to x with 10 mantissa bits, ties away from zero.
__device__ __forceinline__ float round_tf32(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

template <class Epi>
__global__ void __cluster_dims__(T_CLUSTER, 1, 1) __launch_bounds__(G_THREADS, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b_hi,
                   const __grid_constant__ CUtensorMap map_b_lo, int n_cols, int M, int K,
                   const __grid_constant__ Epi epi) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_STAGES * T_STAGE_BYTES);
    uint64_t* empty = full + T_STAGES;
    uint64_t* ready = empty + T_STAGES;  // A split: what the consumers wait for
    uint64_t* turn = ready + T_STAGES;

    if (threadIdx.x == 0) {
        for (int s = 0; s < T_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, T_CLUSTER);
            mbar_init(ready + s, T_SPLITTERS);
        }
        mbar_init(turn, 1);
        mbar_init(turn + 1, 1);
        mbar_fence_init();
    }
    cluster_sync();  // every block's barriers exist before any is used

    const uint32_t rank = cluster_rank();
    const int n_tiles = (n_cols + T_BN - 1) / T_BN;
    const int total = ((M + T_CLUSTER * G_WM - 1) / (T_CLUSTER * G_WM)) * n_tiles;
    const int first = blockIdx.x / T_CLUSTER, step = gridDim.x / T_CLUSTER;
    const int k_steps = K / T_BK;
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        reg_dealloc<40>();
        if (threadIdx.x == 256) {
            uint32_t it = 0;
            for (int t = first; t < total; t += step) {
                const int row0 = (t / n_tiles) * T_CLUSTER * G_WM + rank * G_WM;
                const int col0 = (t % n_tiles) * T_BN + rank * (T_BN / T_CLUSTER);
                for (int kk = 0; kk < k_steps; ++kk, ++it) {
                    const int s = it % T_STAGES;
                    mbar_wait(empty + s, ((it / T_STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(full + s, T_STAGE_TX);
                    unsigned char* st = smem + s * T_STAGE_BYTES;
                    unsigned char* b = st + 2 * T_A_BYTES + rank * (T_B_BYTES / T_CLUSTER);
                    tma_load_2d(st, &map_a, full + s, kk * T_BK, row0);
                    tma_load_2d_multicast(b, &map_b_hi, full + s, kk * T_BK, col0, T_ALL);
                    tma_load_2d_multicast(b + T_B_BYTES, &map_b_lo, full + s, kk * T_BK, col0,
                                          T_ALL);
                }
            }
        } else if (threadIdx.x >= G_THREADS - T_SPLITTERS) {
            // The split, stage after stage as TMA fills them: A's heads over A
            // in place, its tails beside it (the same byte offsets, so the
            // swizzle needs no thought). A splitter cannot fall two phases
            // behind on full[s]: the stage is not refilled before the
            // consumers, who wait for this split, have released it.
            const int t = threadIdx.x - (G_THREADS - T_SPLITTERS);
            const int stages = ((total - first + step - 1) / step) * k_steps;
            for (int it = 0; it < stages; ++it) {
                const int s = it % T_STAGES;
                mbar_wait(full + s, (it / T_STAGES) & 1);
                float4* a4 = reinterpret_cast<float4*>(smem + s * T_STAGE_BYTES);
                float4* l4 = a4 + T_A_BYTES / 16;
#pragma unroll 1
                for (int u = t; u < T_A_BYTES / 16; u += T_SPLITTERS) {
                    const float4 v = a4[u];
                    const float4 h = make_float4(round_tf32(v.x), round_tf32(v.y),
                                                 round_tf32(v.z), round_tf32(v.w));
                    a4[u] = h;
                    l4[u] = make_float4(round_tf32(v.x - h.x), round_tf32(v.y - h.y),
                                        round_tf32(v.z - h.z), round_tf32(v.w - h.w));
                }
                fence_proxy_async();  // the writes, before wgmma reads them
                mbar_arrive(ready + s);
            }
        }
        __syncwarp();
        // No block leaves while its peer may still multicast into its ring or
        // arrive on its barriers.
        cluster_sync();
    } else {
        reg_alloc<232>();
        const int tid = threadIdx.x % 128, lane = threadIdx.x % 32, quad = lane % 4;
        const int wrow = (tid / 32) * 16 + lane / 4;
        const bool elected = tid == 0;
        const uint32_t ring = smem_u32(smem);
        // acc: the tile's sums, added on the FMA pipe (round to nearest);
        // part: the tensor cores' sums over a chain of T_CHAIN stages (128
        // deep), whose adder rounds with a bias that a 2048-deep sum turns
        // into some 2e-5 of the output. A chain ends by waiting for all its
        // products, so the tensor cores idle for a few hundred cycles once a
        // chain. Reading one accumulator set while another is in flight would
        // hide that, and costs more: ptxas then serialises every wgmma.
        float acc[T_BN / 2], part[T_BN / 2];
        // A stage is free once this block's consumer is through with it in
        // every block of the cluster: multicasts write into all their rings.
        auto release = [&](uint32_t s) {
            mbar_arrive(empty + s);
#pragma unroll
            for (int p = 1; p < T_CLUSTER; ++p) mbar_arrive_cluster(empty + s, rank ^ p);
        };
        int item = 0;
        for (int t = first; t < total; t += step, ++item) {
            if ((item & 1) != wg) continue;
            const int row0 = (t / n_tiles) * T_CLUSTER * G_WM + rank * G_WM;
            const int col0 = (t % n_tiles) * T_BN;
            const int valid = n_cols - col0;
            const bool inside = row0 + G_WM <= M && valid >= T_BN;
            RunEpilogue<T_BN, Epi> runs{epi, row0, wrow, quad, col0, valid, M};
            runs.start(inside);

            // Turns as in gemm_wgmma_kernel: a warpgroup looks at a stage's
            // barrier only once the other is through with the stages before.
            if (item > 0) mbar_wait(turn + wg, ((item - 1) / 2) & 1);
#pragma unroll
            for (int i = 0; i < T_BN / 2; ++i) acc[i] = 0.f;
            uint32_t it = (uint32_t)item * k_steps;
            // One chain of L stages, unrolled: every wgmma wait has one place
            // known to ptxas, which then inserts none of its own (a wait it
            // inserts on a branch serialises every wgmma of the kernel).
            auto chain = [&](auto length) {
                constexpr int L = decltype(length)::value;
#pragma unroll
                for (int j = 0; j < L; ++j, ++it) {
                    const int s = it % T_STAGES;
                    mbar_wait(ready + s, (it / T_STAGES) & 1);  // loaded and split
                    const uint32_t a = ring + s * T_STAGE_BYTES;
                    const uint32_t a_lo = a + T_A_BYTES, b = a + 2 * T_A_BYTES, b_lo = b + T_B_BYTES;
                    wgmma_fence();
#pragma unroll
                    for (int k8 = 0; k8 < T_BK / 8; ++k8) {
                        const uint64_t da = desc_k_major(a + k8 * 32), db = desc_k_major(b + k8 * 32);
                        wgmma_tf32_n128(part, da, db, k8 != 0 || j != 0);
                        wgmma_tf32_n128(part, da, desc_k_major(b_lo + k8 * 32), 1);
                        wgmma_tf32_n128(part, desc_k_major(a_lo + k8 * 32), db, 1);
                    }
                    wgmma_commit();
                    if (j == L - 1) {
                        wgmma_wait<0>();
                        if (elected) {
                            if (L > 1) release((it - 1) % T_STAGES);
                            release(s);
                        }
                        fence_registers(part);
#pragma unroll
                        for (int i = 0; i < T_BN / 2; ++i) acc[i] += part[i];
                    } else if (j > 0) {
                        // The previous stage's group is done once one is pending.
                        wgmma_wait<1>();
                        if (elected) release((it - 1) % T_STAGES);
                    }
                }
            };
            if (k_steps % T_CHAIN == 0) {
                for (int kk = 0; kk < k_steps; kk += T_CHAIN)
                    chain(std::integral_constant<int, T_CHAIN>{});
            } else {
                for (int kk = 0; kk < k_steps; kk += 2)  // k_steps is even: K % 64 == 0
                    chain(std::integral_constant<int, 2>{});
            }
            if (elected) mbar_arrive(turn + (wg ^ 1));
            if (inside)
                runs.template run<false>(acc);
            else
                runs.template run<true>(acc);
        }
        cluster_sync();
    }
}
