// place_wave: one wave of the gang placement solve as one CUDA kernel launch.
//
// Replaces the XLA program the JAX package compiles for one wave:
// grove_tpu/solver/core.py `solve_batch_impl` + `_place_gang` (B1: the scan
// over gangs, the scan over pack-sets, the scan over group phases, the
// replica-spread planes included) and `_apply_global_deps` /
// `_scatter_global_ok` (B2: the cross-wave verdict gating). It computes
// exactly what `solve_batch_impl(..., ok_global=...)` computes, gang by gang
// in batch order, and updates `free` and `ok_global` in place (the JAX
// package donates both buffers to the same effect).
//
// Given a candidate plan's gather map `cand_idx`, the same launch also does
// B3 (grove_tpu/solver/pruning.py `CandidatePlan.gather_free` /
// `scatter_free` / `remap_assigned`): it gathers the fleet carry's rows onto
// the candidate axis (pad rows, whose index lies past the fleet, read 0),
// solves the wave there, scatters the candidate rows back into the fleet
// carry (pad rows dropped) and writes `assigned` as fleet ordinals. No
// candidate-axis tensor lives between launches.
//
// Design (right first, not fast). One thread block of 1024 threads owns the
// whole wave; each thread owns a strided set of nodes. Two instantiations
// differ only in where the wave's carry and the gang's working copy live:
// in dynamic shared memory when both fit (2 x N x R f32: 160 KB at N = 5120,
// R = 4), else in global memory (the fleet tensor itself, or a candidate-axis
// scratch, and a scratch working copy), where at these sizes they stay
// resident in the 50 MB L2 (320 KB each at N = 20480). Domain tables and
// per-gang scratch live in global scratch that the wrapper allocates; the
// kernel allocates nothing.
//
// What bounds it: a chain of dependent steps per gang (domain aggregation,
// best-domain argmax per pack-set, one argmax per pod taken), each a few
// __syncthreads apart; each domain sum is itself a sequential walk over the
// domain's nodes, as long as the broadest level's largest domain. It is
// latency-bound: one SM works, 131 of the 132 SMs of an H100 idle, and the
// bytes moved are tiny. A later design would spread the per-gang node work
// over a cluster of blocks (distributed shared memory for the free carry) or
// solve independent shape classes on separate SMs, keep the hoisted domain
// tables in shared memory, and update the domain sums incrementally.
//
// Exactness against the JAX package and the plain PyTorch version
// (grove_tpu_torch/solver/reference.py):
//  - arithmetic uses the IEEE round-to-nearest intrinsics (__fadd_rn,
//    __fmul_rn, __fdiv_rn, ...), which are never contracted into FMAs, and
//    the build passes -fmad=false with no fast math: the slot ratio
//    floor((free + 1e-6) / max(req, 1e-9)) is a correctly rounded division;
//  - scores are built in the reference's operation order, and sums over the
//    resource and pack-set axes run in index order;
//  - top-k by (score desc, node index asc) is an iterated block argmax with
//    the lower index winning ties, as lax.top_k orders ties; the first
//    maximum wins an argmax, and an all -inf argmax returns 0;
//  - domain sums walk a per-level CSR of node indices built once on the host
//    in node order, one thread per (domain, column), adding each node in
//    turn: the sequential order of index_add_ on the host and of the JAX
//    package's segment_sum on the CPU, with no atomics and no TF32. The
//    kernel equals the plain version on any request sizes (100m cpu, 300Mi),
//    not only on the dyadic ones of the bench, where every order sums exactly.

#include <cstdint>

#ifndef PLACE_WAVE_HOST_EMULATION
#include <cuda_runtime.h>
#define PW_WARP 32
#define PW_FULL_MASK 0xffffffffu
#else
#define PW_WARP 1
#endif

#define PW_SLOT_CAP (1 << 20)
#define PW_R_MAX 8
#define PW_MG_MAX 16
#define PW_MS_MAX 8
#define PW_L_MAX 8
#define PW_THREADS 1024
#define PW_EPS 1e-6f

struct PlaceWaveArgs {
  int N, R, L, G, MG, MS, MP, T;  // T = ok_global length, 0 = no chaining
  int NF, cand_count;             // fleet rows of free_io; candidates (pruned)
  float w_tight, w_pref, w_reuse, w_reserve, w_spread;
  // node state; N is the solve's node axis (the candidate pad when pruned)
  float* free_io;                // [NF, R] f32 fleet carry, updated in place
  const int32_t* cand_idx;       // [N] fleet row of each candidate, or null
  const float* capacity;         // [N, R]
  const uint8_t* schedulable;    // [N]
  const int32_t* node_domain_id; // [L, N]
  const int32_t* dom_count;      // [L] domains per level
  const int32_t* dom_offsets;    // [L, N + 1] CSR row starts
  const int32_t* dom_nodes;      // [L, N] node indices, domain-major, node order
  // batch (GangBatch fields)
  const float* group_req;        // [G, MG, R]
  const int32_t* group_total;    // [G, MG]
  const int32_t* group_required; // [G, MG]
  const uint8_t* group_valid;    // [G, MG]
  const uint8_t* set_member;     // [G, MS, MG]
  const int32_t* set_req_level;  // [G, MS]
  const int32_t* set_pref_level; // [G, MS]
  const uint8_t* set_valid;      // [G, MS]
  const int32_t* set_pinned;     // [G, MS]
  const int32_t* pod_group;      // [G, MP]
  const int32_t* pod_rank;       // [G, MP]
  const uint8_t* gang_valid;     // [G]
  const int32_t* group_order;    // [G, MG]
  const int32_t* depends_on;     // [G]
  const int32_t* global_index;   // [G]
  const int32_t* depends_global; // [G]
  const uint8_t* reuse_nodes;    // [G, N] or null
  const uint8_t* group_node_ok;  // [G, MG, N] or null
  const int32_t* spread_level;   // [G] or null (no spread planes)
  const int32_t* spread_family;  // [G]
  const uint8_t* spread_avoid;   // [G, N]
  uint8_t* ok_global;            // [T] or null, updated in place
  // outputs
  int32_t* assigned;             // [G, MP]
  uint8_t* ok;                   // [G], zero on entry
  float* score;                  // [G]
  // global scratch
  float* carry;                  // [N, R] the wave's carry (global, pruned)
  float* carry_g;                // [N, R] the gang's working copy (global)
  uint8_t* family_used;          // [G, N] zeroed (spread family rows)
  uint8_t* avoid;                // [N] the gang's spread avoid set
  float* spread_pen;             // [N] the gang's hoisted spread penalty
  int32_t* slots_all;            // [MG, N]
  float* tables;                 // [L, N, C], C = R + MG + 1
  float* agg;                    // [N, C + 2 + MS]
  uint8_t* feas2;                // [MS, N] per narrow set, per domain row
  uint8_t* node_feas2;           // [MS, N] per narrow set, per node
  uint8_t* node_ok;              // [N]
  uint8_t* ok_nodes;             // [N]
  uint8_t* taken;                // [N]
  uint8_t* used;                 // [N]
  int32_t* a_slots;              // [N]
  float* a_score;                // [N]
  int32_t* entries;              // [2 * MG * MP, 3]: (group, node, count)
};

__device__ __forceinline__ int pw_clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool pw_better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Block-wide argmax by (value desc, index asc). Every thread of the block
// must call it; all get the winner. Index INT32_MAX marks "no candidate".
__device__ void pw_block_argmax(float v, int i, float* red_v, int* red_i,
                                float* out_v, int* out_i) {
  const int lane = threadIdx.x % PW_WARP;
  const int warp = threadIdx.x / PW_WARP;
  const int nwarps = (blockDim.x + PW_WARP - 1) / PW_WARP;
#if PW_WARP > 1
  for (int off = PW_WARP / 2; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(PW_FULL_MASK, v, off);
    int oi = __shfl_xor_sync(PW_FULL_MASK, i, off);
    if (pw_better(ov, oi, v, i)) { v = ov; i = oi; }
  }
#endif
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red_v[lane] : -INFINITY;
    i = lane < nwarps ? red_i[lane] : INT32_MAX;
#if PW_WARP > 1
    for (int off = PW_WARP / 2; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(PW_FULL_MASK, v, off);
      int oi = __shfl_xor_sync(PW_FULL_MASK, i, off);
      if (pw_better(ov, oi, v, i)) { v = ov; i = oi; }
    }
#endif
    if (lane == 0) { *out_v = v; *out_i = i; }
  }
  __syncthreads();
}

// Per-node pod capacity of one request vector (core.py `_group_slots`).
__device__ __forceinline__ int pw_slots(const float* free_row, const float* req, int R) {
  float m = INFINITY;
  for (int r = 0; r < R; ++r) {
    if (req[r] > 0.f) {
      float ratio = floorf(__fdiv_rn(__fadd_rn(free_row[r], PW_EPS), fmaxf(req[r], 1e-9f)));
      m = fminf(m, ratio);
    }
  }
  if (isinf(m)) m = (float)PW_SLOT_CAP;
  m = fminf(fmaxf(m, 0.f), (float)PW_SLOT_CAP);
  return (int)m;
}

// Domain sums at levels [lv0, lv1): out[(lv - lv0) * level_stride + d * K + k]
// = the sum over the nodes i of domain d, in node order, of feat(i, k), k < K.
// One thread owns each (level, domain, column) item and adds the domain's
// nodes one after another, starting from 0 — the order of index_add_ on the
// host — so the sums equal the plain version's on any data. Items are dealt
// to threads in one sequence across the levels, so the long walks of the
// broad levels run side by side with the many short ones of the narrow levels.
template <class Feat>
__device__ void pw_aggregate(const PlaceWaveArgs& a, int lv0, int lv1, int K, Feat feat,
                             float* out, size_t level_stride) {
  const int NT = blockDim.x;
  int base = 0;  // items dealt at earlier levels
  for (int lv = lv0; lv < lv1; ++lv) {
    const int items = a.dom_count[lv] * K;
    const int32_t* off = a.dom_offsets + (size_t)lv * (a.N + 1);
    const int32_t* nodes = a.dom_nodes + (size_t)lv * a.N;
    float* out_lv = out + (size_t)(lv - lv0) * level_stride;
    int first = (int)threadIdx.x - base % NT;
    if (first < 0) first += NT;
    for (int w = first; w < items; w += NT) {
      const int d = w / K, k = w % K;
      float acc = 0.f;
#pragma unroll 4
      for (int p = off[d]; p < off[d + 1]; ++p) acc = __fadd_rn(acc, feat(nodes[p], k));
      out_lv[(size_t)d * K + k] = acc;
    }
    base += items;
  }
}

struct PwGang {
  float req[PW_MG_MAX * PW_R_MAX];
  int total[PW_MG_MAX], required[PW_MG_MAX], order[PW_MG_MAX];
  bool gvalid[PW_MG_MAX];
  bool member[PW_MS_MAX * PW_MG_MAX];  // raw set_member
  bool member2[PW_MS_MAX * PW_MG_MAX]; // set_member & group_valid
  int req_level[PW_MS_MAX], pref_level[PW_MS_MAX], pinned[PW_MS_MAX];
  bool svalid[PW_MS_MAX];
  float demand[PW_MS_MAX * PW_R_MAX];  // per set: sum_g req * required * member2
  bool homogeneous[PW_MS_MAX];
  float joint_need[PW_MS_MAX];
  int creq[PW_MS_MAX], cpref[PW_MS_MAX];
  bool overlap[PW_MS_MAX], active2[PW_MS_MAX];
  bool valid, fail, groups_ok;
  int remaining, n_entries;
  float best_v;
  int best_i;
};

// core.py `_joint_slots_ok` for set s on one domain row's slot sums.
__device__ __forceinline__ bool pw_joint_ok(const PwGang& s_g, const float* slots_row, int s, int MG) {
  if (!s_g.homogeneous[s]) return true;
  float mn = INFINITY;
  for (int g = 0; g < MG; ++g)
    if (s_g.member2[s * PW_MG_MAX + g]) mn = fminf(mn, slots_row[g]);
  return mn >= s_g.joint_need[s];
}

// Domain feasibility shared by the hoisted narrow-set table and pick_domain.
__device__ __forceinline__ bool pw_domain_fits(const PwGang& s_g, const float* row, int s, int R, int MG) {
  for (int r = 0; r < R; ++r)
    if (!(row[r] >= __fsub_rn(s_g.demand[s * PW_R_MAX + r], PW_EPS))) return false;
  for (int g = 0; g < MG; ++g)
    if (s_g.member2[s * PW_MG_MAX + g] && !(row[R + g] >= (float)s_g.required[g])) return false;
  return pw_joint_ok(s_g, row + R, s, MG);
}

// kSharedCarry: the carry and the working copy in dynamic shared memory
// (2 * N * R floats); otherwise in global memory.
template <bool kSharedCarry>
__global__ void __launch_bounds__(PW_THREADS)
place_wave_kernel(const PlaceWaveArgs a) {
  extern __shared__ float pw_smem[];
  __shared__ PwGang s_g;
  __shared__ float cap_scale[PW_R_MAX];
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int N = a.N, R = a.R, L = a.L, MG = a.MG, MS = a.MS, MP = a.MP;
  const int C = R + MG + 1;
  const bool pruned = a.cand_idx != nullptr;
  const bool spread = a.spread_level != nullptr;
  // [N, R] the wave's carry and [N, R] the gang's working copy. A dense
  // solve in global memory works on the fleet tensor itself.
  float* free_s = kSharedCarry ? pw_smem : (pruned ? a.carry : a.free_io);
  float* freeg_s = kSharedCarry ? pw_smem + (size_t)N * R : a.carry_g;

  // cap_scale = max(capacity.max(axis=0), 1e-9)
  for (int r = 0; r < R; ++r) {
    float m = -INFINITY;
    for (int i = tid; i < N; i += NT) m = fmaxf(m, a.capacity[(size_t)i * R + r]);
    // argmax reduction used as a max reduction (index unused)
    pw_block_argmax(m, 0, red_v, red_i, &s_g.best_v, &s_g.best_i);
    if (tid == 0) cap_scale[r] = fmaxf(s_g.best_v, 1e-9f);
    __syncthreads();
  }
  if (pruned) {
    // B3 gather (gather_free, mode="fill"): pad rows point past the fleet.
    for (int k = tid; k < N * R; k += NT) {
      const int src = a.cand_idx[k / R];
      free_s[k] = (src >= 0 && src < a.NF) ? a.free_io[(size_t)src * R + k % R] : 0.f;
    }
  } else if (kSharedCarry) {
    for (int k = tid; k < N * R; k += NT) free_s[k] = a.free_io[k];
  }
  __syncthreads();

  for (int gi = 0; gi < a.G; ++gi) {
    // ---- B2 fold + in-wave depends_on gate --------------------------------
    if (tid == 0) {
      bool valid = a.gang_valid[gi] != 0;
      if (a.T > 0) {
        const int dg = a.depends_global[gi];
        if (dg >= 0) valid = valid && a.ok_global[pw_clip(dg, 0, a.T - 1)] != 0;
      }
      const int dep = a.depends_on[gi];
      if (dep >= 0) valid = valid && a.ok[pw_clip(dep, 0, a.G - 1)] != 0;
      s_g.valid = valid;
    }
    __syncthreads();
    if (!s_g.valid) {
      for (int p = tid; p < MP; p += NT) a.assigned[(size_t)gi * MP + p] = -1;
      if (tid == 0) { a.ok[gi] = 0; a.score[gi] = 0.f; }
      __syncthreads();
      continue;
    }

    // ---- load the gang's rows ----------------------------------------------
    for (int k = tid; k < MG * R; k += NT)
      s_g.req[(k / R) * PW_R_MAX + k % R] = a.group_req[(size_t)gi * MG * R + k];
    for (int g = tid; g < MG; g += NT) {
      s_g.total[g] = a.group_total[gi * MG + g];
      s_g.required[g] = a.group_required[gi * MG + g];
      s_g.gvalid[g] = a.group_valid[gi * MG + g] != 0;
      s_g.order[g] = a.group_order[gi * MG + g];
    }
    for (int k = tid; k < MS * MG; k += NT)
      s_g.member[(k / MG) * PW_MG_MAX + k % MG] = a.set_member[(size_t)gi * MS * MG + k] != 0;
    for (int s = tid; s < MS; s += NT) {
      s_g.req_level[s] = a.set_req_level[gi * MS + s];
      s_g.pref_level[s] = a.set_pref_level[gi * MS + s];
      s_g.svalid[s] = a.set_valid[gi * MS + s] != 0;
      s_g.pinned[s] = a.set_pinned[gi * MS + s];
      s_g.creq[s] = -1;
      s_g.cpref[s] = -1;
    }
    __syncthreads();
    if (tid == 0) {
      s_g.fail = false;
      s_g.groups_ok = true;
      s_g.n_entries = 0;
      for (int s = 0; s < MS; ++s) {
        bool any = false;
        float need = 0.f;
        for (int g = 0; g < MG; ++g) {
          const bool m2 = s_g.member[s * PW_MG_MAX + g] && s_g.gvalid[g];
          s_g.member2[s * PW_MG_MAX + g] = m2;
          any = any || m2;
          need = __fadd_rn(need, __fmul_rn((float)s_g.required[g], m2 ? 1.f : 0.f));
        }
        s_g.joint_need[s] = need;
        bool homog = any;
        for (int r = 0; r < R; ++r) {
          float lo = INFINITY, hi = -INFINITY, dem = 0.f;
          for (int g = 0; g < MG; ++g) {
            const bool m2 = s_g.member2[s * PW_MG_MAX + g];
            const float q = s_g.req[g * PW_R_MAX + r];
            if (m2) { lo = fminf(lo, q); hi = fmaxf(hi, q); }
            dem = __fadd_rn(dem, __fmul_rn(q, (float)(m2 ? s_g.required[g] : 0)));
          }
          s_g.demand[s * PW_R_MAX + r] = dem;
          homog = homog && (__fsub_rn(hi, lo) <= PW_EPS);
        }
        s_g.homogeneous[s] = homog;
      }
    }
    __syncthreads();

    // ---- hoisted replica-spread penalty (core.py:245-261, :580-590) -------
    // avoid = the store's seed | what earlier gangs of the family took
    // (read before this gang writes its row); spread_pen = 1 on nodes whose
    // spread-level domain holds an avoided node.
    if (spread) {
      const int fam = a.spread_family[gi];
      const uint8_t* fam_row = a.family_used + (size_t)pw_clip(fam, 0, a.G - 1) * N;
      const uint8_t* seed = a.spread_avoid + (size_t)gi * N;
      for (int i = tid; i < N; i += NT) a.avoid[i] = seed[i] || (fam >= 0 && fam_row[i]);
      __syncthreads();
      const int s_lvl = a.spread_level[gi];
      const int lvc = pw_clip(s_lvl, 0, L - 1);
      auto feat = [&](int i, int) -> float { return a.avoid[i] ? 1.f : 0.f; };
      pw_aggregate(a, lvc, lvc + 1, 1, feat, a.agg, 0);
      __syncthreads();
      for (int i = tid; i < N; i += NT) {
        const int s_dom = a.node_domain_id[(size_t)lvc * N + i];
        const bool pen = s_lvl >= 0 && s_dom >= 0 && a.agg[pw_clip(s_dom, 0, N - 1)] > 0.5f;
        a.spread_pen[i] = pen ? 1.f : 0.f;
      }
      __syncthreads();
    }

    // ---- hoisted per-gang tables (free is fixed during stage 1) -----------
    const uint8_t* gno = a.group_node_ok ? a.group_node_ok + (size_t)gi * MG * N : nullptr;
    for (int k = tid; k < MG * N; k += NT) {
      const int g = k / N, i = k % N;
      int sl = pw_slots(free_s + (size_t)i * R, s_g.req + g * PW_R_MAX, R);
      if (gno && !gno[k]) sl = 0;
      a.slots_all[k] = sl;
    }
    __syncthreads();
    {
      auto feat = [&](int i, int c) -> float {
        if (!a.schedulable[i]) return 0.f;
        if (c < R) return free_s[(size_t)i * R + c];
        if (c < R + MG) return (float)a.slots_all[(size_t)(c - R) * N + i];
        return 1.f;
      };
      pw_aggregate(a, 0, L, C, feat, a.tables, (size_t)N * C);
    }
    __syncthreads();
    for (int k = tid; k < MS * N; k += NT) {
      const int s2 = k / N, d = k % N;
      const int lv = pw_clip(s_g.req_level[s2], 0, L - 1);
      if (d < a.dom_count[lv])
        a.feas2[k] = pw_domain_fits(s_g, a.tables + ((size_t)lv * N + d) * C, s2, R, MG);
    }
    __syncthreads();
    for (int k = tid; k < MS * N; k += NT) {
      const int s2 = k / N, i = k % N;
      const int lv = pw_clip(s_g.req_level[s2], 0, L - 1);
      const int dom = a.node_domain_id[(size_t)lv * N + i];
      a.node_feas2[k] = dom >= 0 ? a.feas2[(size_t)s2 * N + dom] : 0;
    }
    __syncthreads();

    // ---- Stage 1: commit a domain per pack-set, broadest first ------------
    for (int s = 0; s < MS; ++s) {
      if (tid == 0) {
        for (int s2 = 0; s2 < MS; ++s2) {
          bool ov = false;
          for (int g = 0; g < MG; ++g)
            ov = ov || (s_g.member[s2 * PW_MG_MAX + g] && s_g.member[s * PW_MG_MAX + g]);
          s_g.overlap[s2] = ov;
        }
      }
      __syncthreads();
      for (int i = tid; i < N; i += NT) {
        bool nok = a.schedulable[i] != 0, tk = false;
        for (int s2 = 0; s2 < MS; ++s2) {
          const int c = s_g.creq[s2];
          if (c < 0) continue;
          const int lv = pw_clip(s_g.req_level[s2], 0, L - 1);
          const bool in_dom = a.node_domain_id[(size_t)lv * N + i] == c;
          if (s_g.overlap[s2]) nok = nok && in_dom;
          else if (s_g.svalid[s2]) tk = tk || in_dom;
        }
        a.node_ok[i] = nok;
        a.taken[i] = tk;
      }
      __syncthreads();

      const int req_lv = pw_clip(s_g.req_level[s], 0, L - 1);
      const int32_t* req_dom = a.node_domain_id + (size_t)req_lv * N;
      int new_req = -1, new_pref = -1;
      for (int pass = 0; pass < 2; ++pass) {
        const bool nested = pass == 0;
        const int level = nested ? s_g.req_level[s] : s_g.pref_level[s];
        if (!s_g.svalid[s] || level < 0) continue;  // block-uniform
        const int lv = pw_clip(level, 0, L - 1);
        if (tid == 0) {
          for (int s2 = 0; s2 < MS; ++s2)
            s_g.active2[s2] = s_g.svalid[s2] && s_g.req_level[s2] > level && s_g.overlap[s2];
        }
        for (int i = tid; i < N; i += NT) {
          bool extra;
          if (nested) {
            const int pin = s_g.pinned[s];
            extra = pin < 0 || req_dom[i] == pin;
          } else {
            extra = new_req < 0 || req_dom[i] == new_req;
          }
          a.ok_nodes[i] = a.node_ok[i] && extra;
        }
        __syncthreads();
        // Columns: free [R] | slots [MG] | count | taken | nested [MS] (the
        // required pick only) | spread-touched (with spread planes only).
        const int K_core = C + 1 + (nested ? MS : 0);
        const int K = K_core + (spread ? 1 : 0);
        auto feat = [&](int i, int c) -> float {
          const bool okn = a.ok_nodes[i] != 0;
          if (!okn) return 0.f;
          if (c < R) return free_s[(size_t)i * R + c];
          if (c < R + MG) return (float)a.slots_all[(size_t)(c - R) * N + i];
          if (c == R + MG) return 1.f;
          if (c == C) return a.taken[i] ? 1.f : 0.f;
          if (c == K_core) return a.spread_pen[i];
          return a.node_feas2[(size_t)(c - C - 1) * N + i] ? 1.f : 0.f;
        };
        pw_aggregate(a, lv, lv + 1, K, feat, a.agg, 0);
        __syncthreads();
        float best_v = -INFINITY;
        int best_i = INT32_MAX;
        const int D = a.dom_count[lv];
        for (int d = tid; d < D; d += NT) {
          const float* row = a.agg + (size_t)d * K;
          const float count = row[R + MG];
          bool feasible = count > 0.f && pw_domain_fits(s_g, row, s, R, MG);
          if (feasible && nested) {
            for (int s2 = 0; s2 < MS; ++s2)
              if (s_g.active2[s2] && !(row[C + 1 + s2] > 0.5f)) feasible = false;
          }
          if (!feasible) continue;
          const float taken_frac = __fdiv_rn(row[C], fmaxf(count, 1.f));
          float norm_free = 0.f;
          for (int r = 0; r < R; ++r) norm_free = __fadd_rn(norm_free, __fdiv_rn(row[r], cap_scale[r]));
          float sc = __fsub_rn(-norm_free, __fmul_rn(a.w_reserve, taken_frac));
          if (spread) {
            // A margin above every other score term (core.py:374-387): any
            // feasible domain with no avoided node beats one with them.
            const float big = __fadd_rn(__fadd_rn((float)(N * R), a.w_reserve), 2.f);
            const float touched = row[K_core] > 0.5f ? 1.f : 0.f;
            sc = __fsub_rn(sc, __fmul_rn(a.w_spread > 0.f ? big : 0.f, touched));
          }
          if (pw_better(sc, d, best_v, best_i)) { best_v = sc; best_i = d; }
        }
        pw_block_argmax(best_v, best_i, red_v, red_i, &s_g.best_v, &s_g.best_i);
        const bool any = s_g.best_v > -INFINITY;
        if (nested) {
          new_req = any ? s_g.best_i : -1;
          if (tid == 0 && !any) s_g.fail = true;
        } else {
          new_pref = any ? s_g.best_i : -1;
        }
        __syncthreads();
      }
      if (tid == 0) { s_g.creq[s] = new_req; s_g.cpref[s] = new_pref; }
      __syncthreads();
    }

    // ---- Stage 2: allocate counts per group, floors first, then extras ----
    for (int k = tid; k < N * R; k += NT) freeg_s[k] = free_s[k];
    for (int i = tid; i < N; i += NT)
      a.used[i] = a.reuse_nodes ? (a.reuse_nodes[(size_t)gi * N + i] != 0) : 0;
    __syncthreads();
    int32_t* ent = a.entries;
    for (int t = 0; t < 2 * MG; ++t) {
      const int g = s_g.order[t % MG];
      const int phase = t / MG;
      if (!s_g.gvalid[g]) continue;  // block-uniform; counts stay 0
      const int total = phase == 0 ? s_g.required[g] : s_g.total[g] - s_g.required[g];
      const int floor_req = phase == 0 ? s_g.required[g] : 0;
      const float* req = s_g.req + g * PW_R_MAX;
      for (int i = tid; i < N; i += NT) {
        bool nok = a.schedulable[i] != 0;
        float pref_bonus = 0.f, reserved = 0.f;
        for (int s = 0; s < MS; ++s) {
          const bool memb = s_g.member[s * PW_MG_MAX + g];
          const int cr = s_g.creq[s], cp = s_g.cpref[s];
          const int rl = pw_clip(s_g.req_level[s], 0, L - 1);
          const int pl = pw_clip(s_g.pref_level[s], 0, L - 1);
          const bool in_req = a.node_domain_id[(size_t)rl * N + i] == cr;
          if (memb && cr >= 0) nok = nok && in_req;
          if (memb && cp >= 0 && a.node_domain_id[(size_t)pl * N + i] == cp)
            pref_bonus = __fadd_rn(pref_bonus, 1.f);
          if (!memb && cr >= 0 && in_req) reserved = __fadd_rn(reserved, 1.f);
        }
        if (gno) nok = nok && gno[(size_t)g * N + i] != 0;
        int sl = 0;
        if (nok) {
          sl = pw_slots(freeg_s + (size_t)i * R, req, R);
          sl = sl < total ? sl : total;
        }
        float nf = 0.f;
        for (int r = 0; r < R; ++r) nf = __fadd_rn(nf, __fdiv_rn(freeg_s[(size_t)i * R + r], cap_scale[r]));
        nf = __fdiv_rn(nf, (float)R);
        float sc = __fadd_rn(__fmul_rn(a.w_pref, pref_bonus), __fmul_rn(a.w_reuse, a.used[i] ? 1.f : 0.f));
        sc = __fsub_rn(sc, __fmul_rn(a.w_tight, nf));
        sc = __fsub_rn(sc, __fmul_rn(a.w_reserve, reserved));
        if (spread) sc = __fsub_rn(sc, __fmul_rn(a.w_spread, a.spread_pen[i]));
        a.a_slots[i] = sl;
        a.a_score[i] = sc;
      }
      if (tid == 0) s_g.remaining = total;
      __syncthreads();
      // Top-k as iterated argmax: the best node by (score desc, index asc)
      // takes min(slots, remaining) until the phase's total is placed.
      while (s_g.remaining > 0) {
        float bv = -INFINITY;
        int bi = INT32_MAX;
        for (int i = tid; i < N; i += NT)
          if (a.a_slots[i] > 0 && pw_better(a.a_score[i], i, bv, bi)) { bv = a.a_score[i]; bi = i; }
        pw_block_argmax(bv, bi, red_v, red_i, &s_g.best_v, &s_g.best_i);
        const int node = s_g.best_i;
        if (node == INT32_MAX) break;  // block-uniform: no node has slots left
        if (tid == 0) {
          const int sl = a.a_slots[node];
          const int take = sl < s_g.remaining ? sl : s_g.remaining;
          s_g.remaining -= take;
          a.a_slots[node] = 0;
          const int e = s_g.n_entries++;
          ent[3 * e] = g;
          ent[3 * e + 1] = node;
          ent[3 * e + 2] = take;
          for (int r = 0; r < R; ++r)
            freeg_s[(size_t)node * R + r] =
                __fsub_rn(freeg_s[(size_t)node * R + r], __fmul_rn((float)take, req[r]));
          a.used[node] = 1;
        }
        __syncthreads();
      }
      if (tid == 0 && total - s_g.remaining < floor_req) s_g.groups_ok = false;
      __syncthreads();
    }

    const bool gang_ok = s_g.groups_ok && !s_g.fail;  // s_g.valid holds here
    const int n_ent = s_g.n_entries;

    // ---- Stage 3: counts -> per-pod node (right searchsorted) --------------
    for (int p = tid; p < MP; p += NT) {
      const int pg = a.pod_group[(size_t)gi * MP + p];
      const int pr = a.pod_rank[(size_t)gi * MP + p];
      const int gc = pw_clip(pg, 0, MG - 1);
      int placed = 0;
      for (int e = 0; e < n_ent; ++e)
        if (ent[3 * e] == gc) placed += ent[3 * e + 2];
      int node = -1;
      if (pg >= 0 && pr < placed && gang_ok) {
        // first node j (by index) whose cumulative count exceeds the rank
        int best = INT32_MAX;
        for (int e = 0; e < n_ent; ++e) {
          if (ent[3 * e] != gc) continue;
          const int j = ent[3 * e + 1];
          int cum = 0;
          for (int f = 0; f < n_ent; ++f)
            if (ent[3 * f] == gc && ent[3 * f + 1] <= j) cum += ent[3 * f + 2];
          if (cum > pr && j < best) best = j;
        }
        node = best;
      }
      // Family row write after this gang's own read (core.py:597-607).
      if (node >= 0 && spread && a.spread_family[gi] >= 0)
        a.family_used[(size_t)pw_clip(a.spread_family[gi], 0, a.G - 1) * N + node] = 1;
      // B3 remap (remap_assigned): candidate ordinal -> fleet ordinal.
      if (node >= 0 && pruned) node = a.cand_idx[pw_clip(node, 0, a.cand_count - 1)];
      a.assigned[(size_t)gi * MP + p] = node;
    }

    // ---- Stage 4: placement quality -----------------------------------------
    if (tid == 0) {
      float sum = 0.f;
      int n_pref = 0;
      for (int s = 0; s < MS; ++s) {
        const int lvl = s_g.pref_level[s];
        const int cp = s_g.cpref[s];
        const bool active = lvl >= 0;
        float f = active ? 0.f : 1.f;
        if (active && cp >= 0) {
          const int pl = pw_clip(lvl, 0, L - 1);
          float tot = 0.f, hits = 0.f;
          for (int e = 0; e < n_ent; ++e) {
            if (!s_g.member[s * PW_MG_MAX + ent[3 * e]]) continue;
            const float c = (float)ent[3 * e + 2];
            tot = __fadd_rn(tot, c);
            if (a.node_domain_id[(size_t)pl * N + ent[3 * e + 1]] == cp) hits = __fadd_rn(hits, c);
          }
          f = tot > 0.f ? __fdiv_rn(hits, fmaxf(tot, 1.f)) : 1.f;
        }
        if (s_g.svalid[s] && active) {
          sum = __fadd_rn(sum, f);
          n_pref += 1;
        } else {
          sum = __fadd_rn(sum, 0.f);
        }
      }
      const float mean = n_pref > 0 ? __fdiv_rn(sum, (float)n_pref) : 1.f;
      a.score[gi] = gang_ok ? __fadd_rn(0.5f, __fmul_rn(0.5f, mean)) : 0.f;
      a.ok[gi] = gang_ok ? 1 : 0;
    }

    // ---- all-or-nothing commit of the free carry -----------------------------
    if (gang_ok)
      for (int k = tid; k < N * R; k += NT) free_s[k] = freeg_s[k];
    __syncthreads();
  }

  if (pruned) {
    // B3 scatter (scatter_free): candidate rows back to the fleet; pad rows
    // drop; the plan's indices are unique, so no two threads share a row.
    for (int k = tid; k < N * R; k += NT) {
      const int dst = a.cand_idx[k / R];
      if (dst >= 0 && dst < a.NF) a.free_io[(size_t)dst * R + k % R] = free_s[k];
    }
  } else if (kSharedCarry) {
    for (int k = tid; k < N * R; k += NT) a.free_io[k] = free_s[k];
  }
  // ---- B2 scatter-max of this wave's verdicts into ok_global ---------------
  if (a.T > 0) {
    for (int gi = tid; gi < a.G; gi += NT) {
      const int gidx = a.global_index[gi];
      if (gidx >= 0 && a.ok[gi]) a.ok_global[pw_clip(gidx, 0, a.T - 1)] = 1;
    }
  }
}

#ifndef PLACE_WAVE_HOST_EMULATION
// Launch one wave on `stream`; returns cudaGetLastError() (0 = launched).
// shared_carry picks the instantiation; smem_bytes is its dynamic shared
// memory (2 * N * R * 4 with the carry in shared memory, else 0).
extern "C" int place_wave_launch(const PlaceWaveArgs* args, void* stream, int smem_bytes,
                                 int shared_carry) {
  if (shared_carry) {
    cudaError_t err = cudaFuncSetAttribute(
        place_wave_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    place_wave_kernel<true><<<1, PW_THREADS, smem_bytes, (cudaStream_t)stream>>>(*args);
  } else {
    place_wave_kernel<false><<<1, PW_THREADS, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int place_wave_args_size() { return (int)sizeof(PlaceWaveArgs); }
#endif
