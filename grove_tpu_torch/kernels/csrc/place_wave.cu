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
// What bounds it. Gangs commit one after another, each against the carry
// its predecessors left, so a wave is one chain of dependent steps per gang
// on one thread block (1024 threads, one SM). The bytes moved and the
// operations done are tiny; the chain is the time. Its longest links are the
// domain sums: each is a sequential walk over one domain's nodes in node
// order (below), as long as the broadest level's largest domain (1280 nodes
// of a zone at 5120 nodes, 5120 at 20480), and a walk cannot go faster than
// one dependent f32 add per node, about 4 cycles. What the design does:
//  - a launch is a prologue kernel, one one-thread block per gang on the
//    otherwise idle SMs, that computes everything depending only on a gang's own rows
//    (member2, demand, joint_need, homogeneous, overlap, each nested pass's
//    active2, the gate on ok_global, which sets' tables are read and which
//    slot columns each walk needs) into one PwGangInv record per gang; then
//    the chain kernel, which copies gang i + 1's record into a second
//    shared-memory buffer with cp.async while gang i runs;
//  - only what is read is built: the hoisted narrow-set tables (and their
//    feasibility rows) only at the levels of sets that some nested pass
//    reads, with only the slot columns their fits read; a walk carries only
//    the slot columns of its own set's groups and the nested columns of its
//    active2 sets; slots are computed where a walk stages a node;
//  - a walk first stages its masked feature columns into shared memory in
//    the level's domain-major node order (one coalesced pass over the
//    nodes), then each (domain, column) item adds consecutive shared words
//    with the loads unrolled ahead of the add chain; where the columns do
//    not fit, in chunks of positions, each item carrying its running sum
//    from one chunk to the next in the same order;
//  - the carry lives in global memory (L2) at every size: the fleet tensor
//    itself, or a candidate-axis scratch when pruned. A gang takes nodes in
//    place and logs each row before it changes it, so a rejected gang
//    restores its rows from the log instead of copying the carry per gang;
//  - stage 2 keeps each warp's best (score, index): after a take only the
//    warp that owned the node rescans its nodes, then one 32-way reduction
//    and one barrier pick the next node.
//
// The stacked launch (B5: grove_tpu/solver/core.py `stacked_solve_batch_impl`,
// grove_tpu/parallel/portfolio.py `portfolio_solve_batch`) solves the same
// wave under K weight rows at once: one prologue (it reads no weight), then
// K chain blocks, block k on its own SM with its own weights, carry (a copy
// of the fleet's free taken at its head), scratch and output rows, so the
// launch lasts about as long as its slowest chain. No chain
// writes the fleet carry or ok_global: every variant judges its cross-wave
// dependencies against the one committed history. With `select`, one more
// kernel then ranks the rows as `_objective` does (admitted count, then the
// quality sum in XLA's CPU order, first index on ties), copies the winner's
// rows out and its carry into the fleet's, and scatters its verdicts into
// ok_global. Each row equals a single launch under that row's weights bit
// for bit: the chains run the same code on the same inputs.
//
// The scan launch (B4: grove_tpu/solver/core.py `scan_solve_fn` /
// `scan_pruned_solve_fn`) solves W waves of one shape in one launch: one
// prologue over the W * G gangs, then one chain block that runs the wave
// above W times, step w on step w's rows of every step-strided array (the
// batch, the outputs, and when pruned the plan's node tensors and domain
// index) from the carry step w - 1 left. What a single launch settles once
// per wave is settled at each step's head instead: the cross-wave gate on
// ok_global (the prologue cannot see what earlier steps admit, so the chain
// applies it per gang, after the barrier that follows the previous step's
// scatter), the family rows (zeroed), cap_scale and, when pruned, B3's
// gather; with `free_in`/`okg_in` the head first copies the entering fleet
// carry and ok_global out (the JAX scan's retained, fleet-shaped carries).
// A step whose gangs are all invalid leaves the carry as it found it. Each
// step equals a single launch on its entering carry bit for bit: the same
// code runs on the same inputs. The chain paces it as it paces W single
// launches; a scan saves only the launch gaps and the prologues' waits.
//
// The sweep launch (B6: grove_tpu/solver/core.py `stacked_scan_solve_fn`,
// the tuning sweep's run batcher) solves W journaled waves of one shape under
// K weight rows each, with no carry between the waves: each wave starts from
// its own recorded entering free (`free_in`, [W, N, R], the launch's input).
// The W * K solves are independent, so it is the stacked launch's chain over
// W * K blocks across the SMs: the scan's prologue over the W * G gangs
// (without the cross-wave gate: the sweep passes no ok_global), then block b
// solves step b / K under weight row b % K on the step view of every
// step-strided input, from its own copy of that step's free, with its own
// scratch, into output row b of the W * K (its [b / K, b % K] rows: the
// outputs are not step-strided, as in the stacked launch, which keeps one
// offset fewer live in the chain); it writes no fleet carry. Each block
// holds ~200 KB of dynamic shared memory, so one block fits an SM and the
// launch takes ceil(W * K / SMs) rounds of its slowest chains. Row (w, k)
// equals a single launch of wave w under row k bit for bit: the same code
// runs on the same inputs.
//
// The sharded launch (B7: grove_tpu/solver/core.py:708-761 `sharded_solve_fn`
// with grove_tpu/parallel/mesh.py:149 `SolveLayout`) is the single launch's wave with
// its node axis split into S contiguous row spans: the same prologue, then
// S chain blocks, launched cooperatively so that all are resident, block s
// owning rows [s * N / S, (s + 1) * N / S) of every node tensor (when
// pruned, of the candidate axis: it gathers and scatters only its own
// candidate rows). Block s walks only its own nodes (a per-shard CSR of the
// level's domains, `shard_offsets` / `shard_nodes`) into a partial per
// (domain, column), writes the partial to an exchange buffer in device
// memory and, after a barrier, adds the S partials in shard order: every
// shard then holds the same domain state, the replicated verdict, with no
// atomics in any sum. Feasibility, pick_domain and the stage-1 commits are
// computed by every shard on that state. Stage 2 keeps the chain's
// iterated argmax over the shard's own rows, but a pick records a
// candidate (node, slots, score) instead of taking; the candidates are
// exchanged, and every shard merges the S lists by (score desc, node asc),
// lax.top_k's order, and takes min(slots, remaining) down the merged order,
// changing only its own rows (with its own undo log). Every shard keeps its
// own verdict rows; shard 0's are the outputs, and shard 0 alone scatters
// into ok_global. The barrier is a generation count on a global counter
// (zeroed at each launch); exchange buffers alternate between two halves,
// so one barrier per exchange keeps a later write from meeting an earlier
// read. What bounds it is the single launch's chain plus one barrier per
// domain sum and per stage-2 phase; on virtual shards of one card it adds
// those barriers to the same chain (it splits the walks but not their
// longest domain). A launch across distinct cards is not in it: every
// shard's rows and buffers lie in the one card's memory. Each shard's
// domain sums equal the single launch's node-order sums only where the
// partial sums are exact in f32 (the dyadic requests of the bench fleets);
// its plain version, solver/reference.py `sharded_solve_ref`, adds in the
// same order.
//
// Exactness against the JAX package and the plain PyTorch version
// (grove_tpu_torch/solver/reference.py):
//  - arithmetic uses the IEEE round-to-nearest intrinsics (__fadd_rn,
//    __fmul_rn, __fdiv_rn, ...), which are never contracted into FMAs, and
//    the build passes -fmad=false with no fast math: the slot ratio
//    floor((free + 1e-6) / max(req, 1e-9)) is a correctly rounded division;
//  - scores are built in the reference's operation order, and sums over the
//    resource and pack-set axes run in index order;
//  - top-k by (score desc, node index asc) is an iterated argmax with the
//    lower index winning ties, as lax.top_k orders ties; the first maximum
//    wins an argmax, and an all -inf argmax returns 0;
//  - domain sums add each domain's nodes one after another in node order,
//    over a per-level CSR of node indices built once on the host: the
//    sequential order of index_add_ on the host and of the JAX package's
//    segment_sum on the CPU, with no atomics, no tree and no TF32. Staging
//    and chunking move the operands, not the order. The kernel equals the
//    plain version on any request sizes (100m cpu, 300Mi), not only on the
//    dyadic ones of the bench, where every order sums exactly.

#include <cstdint>
#include <cstring>

#ifndef PLACE_WAVE_HOST_EMULATION
#include <cuda_runtime.h>
#define PW_WARP 32
#define PW_FULL_MASK 0xffffffffu
#define PW_LDCG(p) __ldcg(p)
#else
#include <thread>
#include <vector>
#define PW_WARP 1
#define PW_LDCG(p) (*(p))
#endif

#define PW_SLOT_CAP (1 << 20)
#define PW_R_MAX 8
#define PW_MG_MAX 16
#define PW_MS_MAX 8
#define PW_L_MAX 8
#define PW_THREADS 1024
#define PW_NWARPS (PW_THREADS / 32)
#define PW_EPS 1e-6f
#define PW_INV_BYTES 2048  // global bytes per gang record (kernels/place_wave.py INV_BYTES)
#define PW_S_MAX 8         // shards of a sharded launch (kernels/place_wave.py S_MAX)
// A node's stage-2 word: bits 0-7 inside set s's committed required domain,
// 8-15 inside its committed preferred domain, then these.
#define PW_NW_SCHED (1u << 16)
#define PW_NW_USED (1u << 17)
#define PW_NW_SPREAD (1u << 18)

struct PlaceWaveArgs {
  int N, R, L, G, MG, MS, MP, T;  // T = ok_global length, 0 = no chaining
  int NF, cand_count;             // fleet rows of free_io; candidates (pruned)
  int plane_words;                // f32 words of dynamic shared memory for walks
  int K;                          // weight rows: 1, or the stacked launch's K
  float w_tight, w_pref, w_reuse, w_reserve, w_spread;  // the single launch's
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
  // outputs, one row per weight variant: [K, ...]
  int32_t* assigned;             // [G, MP]
  uint8_t* ok;                   // [G], zero on entry
  float* score;                  // [G]
  // global scratch, one copy per weight variant: [K, ...]
  float* carry;                  // [N, R] the wave's carry (pruned, stacked)
  uint8_t* family_used;          // [G, N] zeroed (spread family rows)
  float* spread_pen;             // [N] the gang's hoisted spread penalty
  float* tables;                 // [L, N, R + MG] narrow-set domain tables
  float* agg;                    // [N, R + MG + MS + 3] a stage-1 walk's sums
  uint8_t* feas2;                // [MS, N] per narrow set, per domain row
  int32_t* nword;                // [N] per node: PW_NW_* bits of the gang's stage 2
  int32_t* a_slots;              // [N]
  float* a_score;                // [N]
  float* norm_free;              // [N] sum_r free / cap_scale over R, per carry row
  int32_t* entries;              // [2 * MG * MP, 3]: (group, node, count)
  float* undo;                   // [2 * MG * MP, R] each taken row before the take
  uint8_t* ginv;                 // [G, PW_INV_BYTES] PwGangInv per gang
  int64_t* prof;                 // [G + 1, PW_NSEC] clock64 cycles per section
  // stacked launch
  const float* params_stack;     // [K, 5] weight rows (SolverParams order)
  float* sel_terms;              // [K, G] select scratch: each row's quality terms
  int32_t* sel_admitted;         // [K] select scratch
  float* sel_quality;            // [K] select scratch
  float* objectives;             // [K] admitted * 1e6 + quality
  int32_t* winner;               // [] the selected row
  int32_t* win_assigned;         // [G, MP] the winner's rows
  uint8_t* win_ok;               // [G]
  float* win_score;              // [G]
  // scan launch: W steps (1 for every other launch); every array named in
  // PW_STEPPED holds step w st_<name> elements past step 0 (0: shared)
  int W;
  // [W, NF, R] each step's entering fleet carry, or null (the scan's output;
  // the sweep launch's input: each step's recorded free)
  float* free_in;
  uint8_t* okg_in;               // [W, T] each step's entering ok_global, or null
  const int32_t* cand_counts;    // [W] candidates of each step's plan (pruned)
  int64_t st_cand_idx, st_capacity, st_schedulable, st_node_domain_id, st_dom_count;
  int64_t st_dom_offsets, st_dom_nodes, st_group_req, st_group_total, st_group_required;
  int64_t st_group_valid, st_set_member, st_set_req_level, st_set_pref_level, st_set_valid;
  int64_t st_set_pinned, st_pod_group, st_pod_rank, st_gang_valid, st_group_order;
  int64_t st_depends_on, st_global_index, st_depends_global, st_reuse_nodes;
  int64_t st_group_node_ok, st_spread_level, st_spread_family, st_spread_avoid;
  int64_t st_assigned, st_ok, st_score, st_ginv, st_free_in, st_okg_in;
  // sharded launch: S shards of N / S rows each
  int S;
  int x_rows, x_words;           // exchange capacity per shard: candidates, f32 words
  const int32_t* shard_offsets;  // [S, L, N + 1] each shard's CSR row starts
  const int32_t* shard_nodes;    // [S, L, N] each shard's nodes, domain-major, node order
  float* xagg;                   // [2, S, x_words] domain partials
  int32_t* xcand;                // [2, S, x_rows, 3] stage-2 candidates (node, slots, score bits)
  int32_t* xcnt;                 // [2, S] candidates per shard
  unsigned* bar;                 // [1] barrier arrivals, zero at launch
};

// The step-strided arrays of a scan launch (kernels/place_wave.py STEPPED).
#define PW_STEPPED(X)                                                                  \
  X(cand_idx) X(capacity) X(schedulable) X(node_domain_id) X(dom_count) X(dom_offsets) \
  X(dom_nodes) X(group_req) X(group_total) X(group_required) X(group_valid)            \
  X(set_member) X(set_req_level) X(set_pref_level) X(set_valid) X(set_pinned)          \
  X(pod_group) X(pod_rank) X(gang_valid) X(group_order) X(depends_on) X(global_index)  \
  X(depends_global) X(reuse_nodes) X(group_node_ok) X(spread_level) X(spread_family)   \
  X(spread_avoid) X(assigned) X(ok) X(score) X(ginv) X(free_in) X(okg_in)

// Step w of a scan launch as the args of one wave. An absent array has
// stride 0 and stays null. No branch: each step pointer is base + w * stride
// from the launch's constants, which the compiler recomputes where it needs
// one instead of keeping (or spilling) it.
__device__ __forceinline__ void pw_step_args(PlaceWaveArgs& s, const PlaceWaveArgs& a, int w) {
  s = a;
#define PW_STEP(f) s.f = a.f + (size_t)w * a.st_##f;
  PW_STEPPED(PW_STEP)
#undef PW_STEP
  if (a.cand_counts) s.cand_count = a.cand_counts[w];
}

// The block's weight variant: blockIdx.x on the card; the host emulation runs
// the stacked launch's blocks one after another and sets pw_emu_block.
#ifndef PLACE_WAVE_HOST_EMULATION
#define PW_BLOCK() ((int)blockIdx.x)
#else
static thread_local int pw_emu_block = 0;
#define PW_BLOCK() pw_emu_block
#endif

// One weight variant's weights, output rows and scratch: row k of each [K,
// ...] array. The single launch has one (k = 0, the scalar weights). In the
// sweep launch block b's output rows and scratch are row b of W * K (its
// [b / K, b % K] rows) and its weights row b % K.
struct PwVariant {
  float w_tight, w_pref, w_reuse, w_reserve, w_spread;
  int32_t* assigned;
  uint8_t* ok;
  float* score;
  float* carry;
  uint8_t* family_used;
  float* spread_pen;
  float* tables;
  float* agg;
  uint8_t* feas2;
  int32_t* nword;
  int32_t* a_slots;
  float* a_score;
  float* norm_free;
  int32_t* entries;
  float* undo;
};

template <bool kStacked, bool kSweep = false, bool kShard = false>
__device__ __forceinline__ PwVariant pw_variant(const PlaceWaveArgs& a) {
  PwVariant V;
  // output and scratch row: the stacked launch's variant, the shard
  const size_t b = kStacked || kShard ? (size_t)PW_BLOCK() : 0;
  const size_t k = kSweep ? b % (size_t)a.K : b;       // weight row
  if (kStacked) {
    const float* w = a.params_stack + 5 * k;
    V.w_tight = w[0]; V.w_pref = w[1]; V.w_reuse = w[2]; V.w_reserve = w[3]; V.w_spread = w[4];
  } else {
    V.w_tight = a.w_tight; V.w_pref = a.w_pref; V.w_reuse = a.w_reuse;
    V.w_reserve = a.w_reserve; V.w_spread = a.w_spread;
  }
  const size_t N = a.N, G = a.G, n_ent = 2 * a.MG * a.MP > 1 ? 2 * a.MG * a.MP : 1;
  V.assigned = a.assigned + b * G * a.MP;
  V.ok = a.ok + b * G;
  V.score = a.score + b * G;
  V.carry = a.carry ? a.carry + b * N * a.R : nullptr;
  V.family_used = a.family_used ? a.family_used + b * G * N : nullptr;
  V.spread_pen = a.spread_pen ? a.spread_pen + b * N : nullptr;
  V.tables = a.tables + b * a.L * N * (a.R + a.MG);
  V.agg = a.agg + b * N * (a.R + a.MG + a.MS + 3);
  V.feas2 = a.feas2 + b * (a.MS > 1 ? a.MS : 1) * N;
  V.nword = a.nword + b * N;
  V.a_slots = a.a_slots + b * N;
  V.a_score = a.a_score + b * N;
  V.norm_free = a.norm_free + b * N;
  V.entries = a.entries + b * n_ent * 3;
  V.undo = a.undo + b * n_ent * a.R;
  return V;
}

// Sections of the profiled instantiation, one column each of `prof`; row gi
// is gang gi, row G the wave's head (cap_scale, B3 gather: column 1) and
// tail (B3 scatter, ok_global: column 10). Slots have no section: a walk
// computes them where it stages a node, and stage 2 where it scores one.
#define PW_NSEC 11
#define PW_SEC_GATE 0
#define PW_SEC_SETUP 1
#define PW_SEC_SPREAD 2
#define PW_SEC_TABLES 3
#define PW_SEC_S1_NODES 4
#define PW_SEC_S1_WALKS 5
#define PW_SEC_S1_ARGMAX 6
#define PW_SEC_S2_SCORE 7
#define PW_SEC_S2_TAKE 8
#define PW_SEC_S34 9
#define PW_SEC_COMMIT 10

// Thread 0 charges the cycles since its last mark to one section; marks sit
// after a barrier, so they time the block. A section that is skipped gets 0.
template <bool kProfile>
struct PwProf {
  long long t;
  int64_t* row;
  __device__ void start(int64_t* r) {
    if (kProfile) { row = r; t = clock64(); }
  }
  __device__ void mark(int sec) {
    if (kProfile && threadIdx.x == 0) {
      const long long now = clock64();
      row[sec] += now - t;
      t = now;
    }
  }
};

// Everything about one gang that depends only on its own rows, computed by
// the prologue for every gang of the wave before the chain starts.
struct __align__(16) PwGangInv {
  float req[PW_MG_MAX * PW_R_MAX];
  float demand[PW_MS_MAX * PW_R_MAX];      // per set: sum_g req * required * member2
  float joint_need[PW_MS_MAX];
  int total[PW_MG_MAX], required[PW_MG_MAX], order[PW_MG_MAX];
  int req_level[PW_MS_MAX], pref_level[PW_MS_MAX], pinned[PW_MS_MAX];
  int valid0;          // gang_valid and the ok_global gate (B2)
  int depends_on;      // in-wave base gang, or -1
  int spread_level, spread_family;
  int table_levels;    // bit lv: the narrow-set tables at level lv are read
  uint8_t gvalid[PW_MG_MAX];
  uint8_t member[PW_MS_MAX * PW_MG_MAX];   // raw set_member
  uint8_t svalid[PW_MS_MAX], homogeneous[PW_MS_MAX];
  uint8_t need_table[PW_MS_MAX];           // set s2's feasibility row is read
  uint8_t overlap[PW_MS_MAX * PW_MS_MAX];  // [s][s2]: they share a group
  uint8_t active2[PW_MS_MAX * PW_MS_MAX];  // [s][s2]: s's nested pass reads s2
  uint8_t memb_bits[PW_MG_MAX];            // bit s: set s holds group g (raw)
  // slot columns of set s: its member2 groups in index order, and where each
  // sits in the table of s's required level
  uint8_t s_ng[PW_MS_MAX];
  uint8_t s_grp[PW_MS_MAX * PW_MG_MAX];
  uint8_t s_tcol[PW_MS_MAX * PW_MG_MAX];
  uint8_t tab_ng[PW_L_MAX];                // slot columns of each level's table
  uint8_t tab_grp[PW_L_MAX * PW_MG_MAX];
};
static_assert(sizeof(PwGangInv) % 16 == 0, "PwGangInv is copied in 16-byte pieces");
static_assert(sizeof(PwGangInv) <= PW_INV_BYTES, "PwGangInv outgrew its global record");

__device__ __forceinline__ int pw_clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool pw_better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ int pw_popc(unsigned v) {
  int c = 0;
  for (; v; v &= v - 1) ++c;
  return c;
}

// Warp-wide argmax by (value desc, index asc); every lane gets the winner.
__device__ __forceinline__ void pw_warp_argmax(float& v, int& i) {
#if PW_WARP > 1
  for (int off = PW_WARP / 2; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(PW_FULL_MASK, v, off);
    int oi = __shfl_xor_sync(PW_FULL_MASK, i, off);
    if (pw_better(ov, oi, v, i)) { v = ov; i = oi; }
  }
#endif
}

__device__ __forceinline__ void pw_syncwarp() {
#if PW_WARP > 1
  __syncwarp();
#endif
}

// Block-wide argmax by (value desc, index asc). Every thread of the block
// must call it; all get the winner. Index INT32_MAX marks "no candidate".
__device__ void pw_block_argmax(float v, int i, float* red_v, int* red_i,
                                float* out_v, int* out_i) {
  const int lane = threadIdx.x % PW_WARP;
  const int warp = threadIdx.x / PW_WARP;
  const int nwarps = (blockDim.x + PW_WARP - 1) / PW_WARP;
  pw_warp_argmax(v, i);
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red_v[lane] : -INFINITY;
    i = lane < nwarps ? red_i[lane] : INT32_MAX;
    pw_warp_argmax(v, i);
    if (lane == 0) { *out_v = v; *out_i = i; }
  }
  __syncthreads();
}

// Copies of a gang record into shared memory: cp.async on the card (16
// bytes a piece, completion by commit group), a plain copy in emulation.
__device__ __forceinline__ void pw_copy16_async(void* dst, const void* src) {
#ifndef PLACE_WAVE_HOST_EMULATION
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void pw_async_commit() {
#ifndef PLACE_WAVE_HOST_EMULATION
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most one commit group (the newest) is still in flight.
__device__ __forceinline__ void pw_async_wait_all_but_one() {
#ifndef PLACE_WAVE_HOST_EMULATION
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

__device__ void pw_fetch_gang(PwGangInv* dst, const PlaceWaveArgs& a, int gi) {
  if (gi < a.G) {
    const uint8_t* src = a.ginv + (size_t)gi * PW_INV_BYTES;
    for (int k = threadIdx.x; k < (int)(sizeof(PwGangInv) / 16); k += blockDim.x)
      pw_copy16_async((uint8_t*)dst + 16 * k, src + 16 * k);
  }
  pw_async_commit();  // an empty group past the last gang keeps the count
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

// mean_r(free / cap_scale) of one carry row, in the reference's order
// (core.py alloc_group's norm_free).
__device__ __forceinline__ float pw_norm_free(const float* free_row, const float* cap_scale, int R) {
  float nf = 0.f;
  for (int r = 0; r < R; ++r) nf = __fadd_rn(nf, __fdiv_rn(free_row[r], cap_scale[r]));
  return __fdiv_rn(nf, (float)R);
}

// Slots of group g on node i (carry row `free_row`), masked by the gang's
// group_node_ok rows (`gno`, or null).
__device__ __forceinline__ float pw_node_slots(const PwGangInv& v, const float* free_row,
                                               const uint8_t* gno, int g, int i, int N, int R) {
  if (gno && !gno[(size_t)g * N + i]) return 0.f;
  return (float)pw_slots(free_row, v.req + g * PW_R_MAX, R);
}

// Domain feasibility of set s on a row [free R | slot columns]: the slot of
// s's j-th member2 group sits at row[R + col[j]], or row[R + j] without
// `col` (core.py pick_domain's feas_cap and feas_slots, `_joint_slots_ok`).
__device__ __forceinline__ bool pw_domain_fits(const PwGangInv& v, const float* row, int s,
                                               const uint8_t* col, int R) {
  for (int r = 0; r < R; ++r)
    if (!(row[r] >= __fsub_rn(v.demand[s * PW_R_MAX + r], PW_EPS))) return false;
  const int ng = v.s_ng[s];
  float mn = INFINITY;
  for (int j = 0; j < ng; ++j) {
    const float sl = row[R + (col ? col[j] : j)];
    if (!(sl >= (float)v.required[v.s_grp[s * PW_MG_MAX + j]])) return false;
    mn = fminf(mn, sl);
  }
  return !v.homogeneous[s] || mn >= v.joint_need[s];
}

// acc + col[p0] + ... + col[p1 - 1], added one after another; the loads of
// the next eight words are issued before the adds of the current eight.
__device__ __forceinline__ float pw_sum_run(const float* col, int p0, int p1, float acc) {
  int p = p0;
  if (p + 8 <= p1) {
    float x0 = col[p], x1 = col[p + 1], x2 = col[p + 2], x3 = col[p + 3];
    float x4 = col[p + 4], x5 = col[p + 5], x6 = col[p + 6], x7 = col[p + 7];
    for (p += 8; p + 8 <= p1; p += 8) {
      const float y0 = col[p], y1 = col[p + 1], y2 = col[p + 2], y3 = col[p + 3];
      const float y4 = col[p + 4], y5 = col[p + 5], y6 = col[p + 6], y7 = col[p + 7];
      acc = __fadd_rn(acc, x0); acc = __fadd_rn(acc, x1);
      acc = __fadd_rn(acc, x2); acc = __fadd_rn(acc, x3);
      acc = __fadd_rn(acc, x4); acc = __fadd_rn(acc, x5);
      acc = __fadd_rn(acc, x6); acc = __fadd_rn(acc, x7);
      x0 = y0; x1 = y1; x2 = y2; x3 = y3; x4 = y4; x5 = y5; x6 = y6; x7 = y7;
    }
    acc = __fadd_rn(acc, x0); acc = __fadd_rn(acc, x1);
    acc = __fadd_rn(acc, x2); acc = __fadd_rn(acc, x3);
    acc = __fadd_rn(acc, x4); acc = __fadd_rn(acc, x5);
    acc = __fadd_rn(acc, x6); acc = __fadd_rn(acc, x7);
  }
  for (; p < p1; ++p) acc = __fadd_rn(acc, col[p]);
  return acc;
}

// Domain sums of K staged columns at level lv: out[d * K + k] = the sum, in
// node order, of column k over domain d's nodes. `stage(i, dst, P)` writes
// node i's K values to dst[k * P]. Positions (the level's domain-major node
// order) are staged into `plane` in chunks of P <= plane_words / K; then each
// (domain, column) item adds its domain's words of the chunk one after
// another, from 0 at the domain's first position and from its running sum in
// `out` past a chunk boundary: one sequential sum per item, the order of
// index_add_ on the host. Every domain < dom_count[lv] is written.
//
// A level of at most PW_NWARPS domains (the broad levels, whose walks are
// long) is walked in rounds instead: round r stages the next Q = P / D
// positions of every domain side by side, so all domains advance together
// and the chain is the longest domain, not the level. Each warp walks one
// domain, a lane per column: with P = 1 (mod 32) the lanes' words sit in
// distinct banks, so a step costs one conflict-free load and one add. In a
// chunk that holds few domains the warps walk them the same way; otherwise
// the items are dealt to the threads in one sequence.
template <class Stage, class Prof>
__device__ void pw_walk(const PlaceWaveArgs& a, int lv, int K, Stage stage, float* out,
                        float* plane, Prof& prof, int stage_sec, int walk_sec) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid % PW_WARP, warp = tid / PW_WARP, NW = (NT + PW_WARP - 1) / PW_WARP;
  const int N = a.N;
  const int32_t* off = a.dom_offsets + (size_t)lv * (N + 1);
  const int32_t* nodes = a.dom_nodes + (size_t)lv * N;
  const int32_t* ndid = a.node_domain_id + (size_t)lv * N;
  const int D = a.dom_count[lv];
  const int total = off[D];
  int P = a.plane_words / K;
  if (P > 32) P = ((P - 1) & ~31) + 1;  // P = 1 (mod 32)
  if (D > 0 && D <= PW_NWARPS && P >= D) {
    const int Q = P / D;
    int longest = 0;
    for (int d = 0; d < D; ++d)
      if (off[d + 1] - off[d] > longest) longest = off[d + 1] - off[d];
    for (int r0 = 0; r0 == 0 || r0 < longest; r0 += Q) {
      for (int w = tid; w < D * Q; w += NT) {
        const int d = w / Q, p = off[d] + r0 + w % Q;
        if (p < off[d + 1]) stage(nodes[p], plane + w, P);
      }
      __syncthreads();
      prof.mark(stage_sec);
      for (int d = warp; d < D; d += NW) {
        const int o0 = off[d] + r0, o1 = off[d + 1] < o0 + Q ? off[d + 1] : o0 + Q;
        for (int k = lane; k < K; k += PW_WARP) {
          const float acc = r0 == 0 ? 0.f : out[(size_t)d * K + k];
          out[(size_t)d * K + k] = pw_sum_run(plane + (size_t)k * P + d * Q - o0, o0, o1, acc);
        }
      }
      __syncthreads();
      prof.mark(walk_sec);
    }
    return;
  }
  for (int c0 = 0; c0 < total; c0 += P) {
    const int c1 = c0 + P < total ? c0 + P : total;
    for (int p = c0 + tid; p < c1; p += NT) stage(nodes[p], plane + (p - c0), P);
    __syncthreads();
    prof.mark(stage_sec);
    const int d_lo = c0 == 0 ? 0 : ndid[nodes[c0]];
    const int d_hi = c1 == total ? D - 1 : ndid[nodes[c1 - 1]];
    auto item = [&](int d, int k) {
      const int o0 = off[d], o1 = off[d + 1];
      const int p0 = o0 > c0 ? o0 : c0, p1 = o1 < c1 ? o1 : c1;
      const float acc = o0 >= c0 ? 0.f : out[(size_t)d * K + k];
      out[(size_t)d * K + k] = pw_sum_run(plane + (size_t)k * P - c0, p0, p1, acc);
    };
    if (d_hi - d_lo < NW) {
      for (int d = d_lo + warp; d <= d_hi; d += NW)
        for (int k = lane; k < K; k += PW_WARP) item(d, k);
    } else {
      const int items = (d_hi - d_lo + 1) * K;
      for (int w = tid; w < items; w += NT) item(d_lo + w / K, w % K);
    }
    __syncthreads();
    prof.mark(walk_sec);
  }
}

// ---- B7: the shards' barrier and exchanges ---------------------------------

__device__ __forceinline__ int pw_f2i(float x) {
  int i;
  memcpy(&i, &x, 4);
  return i;
}

__device__ __forceinline__ float pw_i2f(int i) {
  float x;
  memcpy(&x, &i, 4);
  return x;
}

// Every block of the sharded launch waits here until all S have arrived:
// `gen` counts this block's barriers, and the counter reaches gen * S once
// every block has passed its gen-th. The fences order each block's writes
// before its arrival and the others' writes before its reads.
__device__ void pw_grid_sync(const PlaceWaveArgs& a, unsigned& gen) {
  __syncthreads();
  ++gen;
  if (threadIdx.x == 0) {
    const unsigned want = gen * (unsigned)a.S;
#ifndef PLACE_WAVE_HOST_EMULATION
    __threadfence();
    atomicAdd(a.bar, 1u);
    while (*(volatile unsigned*)a.bar < want) __nanosleep(20);
    __threadfence();
#else
    __atomic_fetch_add(a.bar, 1u, __ATOMIC_SEQ_CST);
    while (__atomic_load_n(a.bar, __ATOMIC_SEQ_CST) < want) std::this_thread::yield();
#endif
  }
  __syncthreads();
}

// A domain walk of the sharded launch: the shard walks its own nodes (its
// CSR is the level's in `a`) into its partial in the exchange buffer, then,
// past the barrier, out[d * K + k] = the S partials added in shard order.
// Unsharded it is pw_walk into `out`.
template <bool kShard, class Stage, class Prof>
__device__ void pw_walk_x(const PlaceWaveArgs& a, int lv, int K, Stage stage, float* out,
                          float* plane, Prof& prof, int stage_sec, int walk_sec, int shard,
                          unsigned& gen, int& xpar) {
  if constexpr (!kShard) {
    pw_walk(a, lv, K, stage, out, plane, prof, stage_sec, walk_sec);
  } else {
    float* mine = a.xagg + ((size_t)xpar * a.S + shard) * a.x_words;
    const int D = a.dom_count[lv];
    if (a.dom_offsets[(size_t)lv * (a.N + 1) + D] == 0) {
      // No node of this shard lies in a domain of the level: a zero partial.
      for (int k = threadIdx.x; k < D * K; k += blockDim.x) mine[k] = 0.f;
    } else {
      pw_walk(a, lv, K, stage, mine, plane, prof, stage_sec, walk_sec);
    }
    pw_grid_sync(a, gen);
    const float* x0 = a.xagg + (size_t)xpar * a.S * a.x_words;
    for (int k = threadIdx.x; k < D * K; k += blockDim.x) {
      float acc = PW_LDCG(x0 + k);
      for (int s = 1; s < a.S; ++s) acc = __fadd_rn(acc, PW_LDCG(x0 + (size_t)s * a.x_words + k));
      out[k] = acc;
    }
    __syncthreads();
    xpar ^= 1;
  }
}

// ---- prologue: one gang's invariants ----------------------------------------
__device__ void pw_gang_invariants(const PlaceWaveArgs& a, int gi) {
  PwGangInv& v = *(PwGangInv*)(a.ginv + (size_t)gi * PW_INV_BYTES);
  memset(&v, 0, sizeof(PwGangInv));
  const int R = a.R, L = a.L, MG = a.MG, MS = a.MS;
  for (int k = 0; k < MG * R; ++k)
    v.req[(k / R) * PW_R_MAX + k % R] = a.group_req[(size_t)gi * MG * R + k];
  for (int g = 0; g < MG; ++g) {
    v.total[g] = a.group_total[gi * MG + g];
    v.required[g] = a.group_required[gi * MG + g];
    v.gvalid[g] = a.group_valid[gi * MG + g] != 0;
    v.order[g] = a.group_order[gi * MG + g];
  }
  for (int s = 0; s < MS; ++s) {
    v.req_level[s] = a.set_req_level[gi * MS + s];
    v.pref_level[s] = a.set_pref_level[gi * MS + s];
    v.svalid[s] = a.set_valid[gi * MS + s] != 0;
    v.pinned[s] = a.set_pinned[gi * MS + s];
    for (int g = 0; g < MG; ++g) {
      const bool m = a.set_member[((size_t)gi * MS + s) * MG + g] != 0;
      v.member[s * PW_MG_MAX + g] = m;
      if (m) v.memb_bits[g] |= (uint8_t)(1u << s);
    }
  }
  // B2 fold of the cross-wave gate: ok_global changes only after the wave.
  bool valid = a.gang_valid[gi] != 0;
  if (a.T > 0) {
    const int dg = a.depends_global[gi];
    if (dg >= 0) valid = valid && a.ok_global[pw_clip(dg, 0, a.T - 1)] != 0;
  }
  v.valid0 = valid;
  v.depends_on = a.depends_on[gi];
  v.spread_level = a.spread_level ? a.spread_level[gi] : -1;
  v.spread_family = a.spread_level ? a.spread_family[gi] : -1;
  for (int s = 0; s < MS; ++s) {
    bool any = false;
    float need = 0.f;
    for (int g = 0; g < MG; ++g) {
      const bool m2 = v.member[s * PW_MG_MAX + g] && v.gvalid[g];
      if (m2) v.s_grp[s * PW_MG_MAX + v.s_ng[s]++] = (uint8_t)g;
      any = any || m2;
      need = __fadd_rn(need, __fmul_rn((float)v.required[g], m2 ? 1.f : 0.f));
    }
    v.joint_need[s] = need;
    bool homog = any;
    for (int r = 0; r < R; ++r) {
      float lo = INFINITY, hi = -INFINITY, dem = 0.f;
      for (int g = 0; g < MG; ++g) {
        const bool m2 = v.member[s * PW_MG_MAX + g] && v.gvalid[g];
        const float q = v.req[g * PW_R_MAX + r];
        if (m2) { lo = fminf(lo, q); hi = fmaxf(hi, q); }
        dem = __fadd_rn(dem, __fmul_rn(q, (float)(m2 ? v.required[g] : 0)));
      }
      v.demand[s * PW_R_MAX + r] = dem;
      homog = homog && (__fsub_rn(hi, lo) <= PW_EPS);
    }
    v.homogeneous[s] = homog;
    for (int s2 = 0; s2 < MS; ++s2) {
      bool ov = false;
      for (int g = 0; g < MG; ++g)
        ov = ov || (v.member[s2 * PW_MG_MAX + g] && v.member[s * PW_MG_MAX + g]);
      v.overlap[s * PW_MS_MAX + s2] = ov;
    }
  }
  // Which feasibility rows a nested pass reads: set s's nested pass runs when
  // s is valid with a required level, and reads set s2 when s2 is valid,
  // overlaps s and requires a narrower level (core.py nested_feasible).
  for (int s = 0; s < MS; ++s) {
    if (!v.svalid[s] || v.req_level[s] < 0) continue;
    for (int s2 = 0; s2 < MS; ++s2) {
      const bool act = v.svalid[s2] && v.req_level[s2] > v.req_level[s] &&
                       v.overlap[s * PW_MS_MAX + s2];
      v.active2[s * PW_MS_MAX + s2] = act;
      if (act) v.need_table[s2] = 1;
    }
  }
  for (int s2 = 0; s2 < MS; ++s2) {
    if (!v.need_table[s2]) continue;
    const int lv = pw_clip(v.req_level[s2], 0, L - 1);
    v.table_levels |= 1 << lv;
    for (int j = 0; j < v.s_ng[s2]; ++j) {
      const int g = v.s_grp[s2 * PW_MG_MAX + j];
      int c = 0;
      while (c < v.tab_ng[lv] && v.tab_grp[lv * PW_MG_MAX + c] != g) ++c;
      if (c == v.tab_ng[lv]) v.tab_grp[lv * PW_MG_MAX + v.tab_ng[lv]++] = (uint8_t)g;
      v.s_tcol[s2 * PW_MG_MAX + j] = (uint8_t)c;
    }
  }
}

// The scan's prologue, gang b of the W * G: gang b % G of step b / G, whose
// cross-wave gate the chain applies (T = 0 here: ok_global changes between
// the steps).
__device__ void pw_scan_invariants(const PlaceWaveArgs& a0, int b) {
  PlaceWaveArgs a;
  pw_step_args(a, a0, b / a0.G);
  a.T = 0;
  pw_gang_invariants(a, b % a0.G);
}

#ifndef PLACE_WAVE_HOST_EMULATION
__global__ void place_wave_prologue(const PlaceWaveArgs a) { pw_gang_invariants(a, blockIdx.x); }
__global__ void place_wave_scan_prologue(const PlaceWaveArgs a) { pw_scan_invariants(a, blockIdx.x); }
#endif

// ---- the chain: every gang of the wave, in batch order ----------------------
// (the scan: every gang of each step in turn, the steps in order; the sweep,
// kStacked && kScan: one step per block)
template <bool kProfile, bool kStacked, bool kScan, bool kShard = false>
__global__ void __launch_bounds__(PW_THREADS)
place_wave_kernel(const PlaceWaveArgs a0) {
#ifndef PLACE_WAVE_HOST_EMULATION
  extern __shared__ float pw_plane[];  // a.plane_words f32 for the walks
#endif
  __shared__ PwGangInv s_inv[2];
  __shared__ float cap_scale[PW_R_MAX];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ float wb_v[2][PW_NWARPS];  // stage 2: each warp's best, two buffers
  __shared__ int wb_i[2][PW_NWARPS];
  __shared__ int s_rem[2];
  __shared__ int s_creq[PW_MS_MAX], s_cpref[PW_MS_MAX];
  __shared__ int s_n_entries;
  __shared__ float s_best_v;
  __shared__ int s_best_i;
  __shared__ int s_ncand;  // the sharded launch: this phase's candidates

  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int lane = tid % PW_WARP, warp = tid / PW_WARP;
  const int NW = (NT + PW_WARP - 1) / PW_WARP;
  constexpr bool kSweep = kStacked && kScan;
  const int shard = kShard ? PW_BLOCK() : 0;
  unsigned bar_gen = 0;  // barriers this block has passed (sharded)
  int xpar = 0;          // the exchange buffers' half in use (sharded)
  const int step_lo = kSweep ? PW_BLOCK() / a0.K : 0;
  const int step_hi = kSweep ? step_lo + 1 : (kScan ? a0.W : 1);
  for (int step = step_lo; step < step_hi; ++step) {
    // The scan's step view is every thread's own: a copy in shared memory
    // made each field a load and spilled, 1.2x the steps' single launches
    // on the H100 (PERF.md).
    PlaceWaveArgs a_step;
    if constexpr (kScan) {
      // The previous step's tail (the carry's scatter, ok_global) is in
      // place for this step's head to read.
      __syncthreads();
      pw_step_args(a_step, a0, step);
    } else if constexpr (kShard) {
      // The shard walks its own nodes: its CSR stands in for the level's.
      a_step = a0;
      a_step.dom_offsets = a0.shard_offsets + (size_t)shard * a0.L * (a0.N + 1);
      a_step.dom_nodes = a0.shard_nodes + (size_t)shard * a0.L * a0.N;
    }
    const PlaceWaveArgs& a = kScan || kShard ? a_step : a0;
    const int N = a.N, R = a.R, L = a.L, MG = a.MG, MS = a.MS, MP = a.MP;
    // The rows this block owns: all of them but in the sharded launch.
    const int row_lo = kShard ? shard * (N / a.S) : 0;
    const int row_hi = kShard ? row_lo + N / a.S : N;
    const bool pruned = a.cand_idx != nullptr;
    const bool spread = a.spread_level != nullptr;
    const PwVariant V = pw_variant<kStacked, kSweep, kShard>(a);
    float* free_s = pruned || kStacked ? V.carry : a.free_io;  // [N, R] the wave's carry
    PwProf<kProfile> prof;
    prof.start(a.prof ? a.prof + (size_t)a.G * PW_NSEC : nullptr);
    if (kScan) {
      // The entering fleet carry, before the pruned gather (fleet-shaped, as
      // the JAX scan retains it), and a fresh set of family rows.
      if (a.free_in && !kSweep)
        for (int k = tid; k < a.NF * R; k += NT) a.free_in[k] = a.free_io[k];
      if (a.okg_in)
        for (int k = tid; k < a.T; k += NT) a.okg_in[k] = a.ok_global[k];
      if (spread)
        for (size_t k = tid; k < (size_t)a.G * N; k += NT) V.family_used[k] = 0;
    }

    pw_fetch_gang(&s_inv[0], a, 0);
    // cap_scale = max(capacity.max(axis=0), 1e-9)
    for (int r = 0; r < R; ++r) {
      float m = -INFINITY;
      for (int i = tid; i < N; i += NT) m = fmaxf(m, a.capacity[(size_t)i * R + r]);
      // argmax reduction used as a max reduction (index unused)
      pw_block_argmax(m, 0, red_v, red_i, &s_best_v, &s_best_i);
      if (tid == 0) cap_scale[r] = fmaxf(s_best_v, 1e-9f);
      __syncthreads();
    }
    if (pruned) {
      // B3 gather (gather_free, mode="fill"): pad rows point past the fleet.
      for (int k = row_lo * R + tid; k < row_hi * R; k += NT) {
        const int src = a.cand_idx[k / R];
        free_s[k] = (src >= 0 && src < a.NF) ? a.free_io[(size_t)src * R + k % R] : 0.f;
      }
      __syncthreads();
    } else if (kStacked) {
      // Each variant starts from its own copy of the fleet carry (the sweep:
      // of its step's recorded free).
      const float* src = kSweep ? a.free_in : a.free_io;
      for (int k = tid; k < N * R; k += NT) free_s[k] = src[k];
      __syncthreads();
    }
    // Each carry row's normalised free capacity, kept beside the carry and
    // recomputed wherever a row changes: stage 2 reads it once per node.
    for (int i = row_lo + tid; i < row_hi; i += NT)
      V.norm_free[i] = pw_norm_free(free_s + (size_t)i * R, cap_scale, R);
    __syncthreads();
    prof.mark(PW_SEC_SETUP);

    for (int gi = 0; gi < a.G; ++gi) {
      if (kProfile) prof.row = a.prof + (size_t)gi * PW_NSEC;
      // ---- gang record (prefetched) + B2/in-wave gate -----------------------
      pw_fetch_gang(&s_inv[(gi + 1) & 1], a, gi + 1);
      pw_async_wait_all_but_one();
      if (tid == 0) {
        s_n_entries = 0;
        for (int s = 0; s < PW_MS_MAX; ++s) { s_creq[s] = -1; s_cpref[s] = -1; }
      }
      __syncthreads();
      const PwGangInv& v = s_inv[gi & 1];
      bool valid = v.valid0 != 0;
      if (kScan && a.T > 0) {
        // B2's gate against ok_global as the earlier steps left it (it
        // changes only at a step's tail).
        const int dg = a.depends_global[gi];
        if (dg >= 0) valid = valid && a.ok_global[pw_clip(dg, 0, a.T - 1)] != 0;
      }
      if (v.depends_on >= 0) valid = valid && V.ok[pw_clip(v.depends_on, 0, a.G - 1)] != 0;
      if (!valid) {
        for (int p = tid; p < MP; p += NT) V.assigned[(size_t)gi * MP + p] = -1;
        if (tid == 0) { V.ok[gi] = 0; V.score[gi] = 0.f; }
        __syncthreads();
        prof.mark(PW_SEC_GATE);
        continue;
      }
      prof.mark(PW_SEC_GATE);
      const uint8_t* gno = a.group_node_ok ? a.group_node_ok + (size_t)gi * MG * N : nullptr;

      // ---- hoisted replica-spread penalty (core.py:245-261, :580-590) -------
      // avoid = the store's seed | what earlier gangs of the family took
      // (read before this gang writes its row); spread_pen = 1 on nodes whose
      // spread-level domain holds an avoided node.
      if (spread) {
        const int fam = v.spread_family;
        const uint8_t* fam_row = V.family_used + (size_t)pw_clip(fam, 0, a.G - 1) * N;
        const uint8_t* seed = a.spread_avoid + (size_t)gi * N;
        const int s_lvl = v.spread_level;
        const int lvc = pw_clip(s_lvl, 0, L - 1);
        if (s_lvl >= 0) {  // block-uniform; without a level no node is penalised
          auto stage = [&](int i, float* dst, int) {
            dst[0] = (seed[i] || (fam >= 0 && fam_row[i])) ? 1.f : 0.f;
          };
          pw_walk_x<kShard>(a, lvc, 1, stage, V.agg, pw_plane, prof, PW_SEC_SPREAD, PW_SEC_SPREAD,
                            shard, bar_gen, xpar);
        }
        for (int i = row_lo + tid; i < row_hi; i += NT) {
          const int s_dom = a.node_domain_id[(size_t)lvc * N + i];
          const bool pen = s_lvl >= 0 && s_dom >= 0 && V.agg[pw_clip(s_dom, 0, N - 1)] > 0.5f;
          V.spread_pen[i] = pen ? 1.f : 0.f;
        }
        __syncthreads();
        prof.mark(PW_SEC_SPREAD);
      }

      // ---- narrow-set tables, only where a nested pass reads them ------------
      // (free is fixed during stage 1; tables over schedulable nodes.)
      if (v.table_levels) {
        for (int lv = 0; lv < L; ++lv) {
          if (!(v.table_levels >> lv & 1)) continue;
          const int ng = v.tab_ng[lv];
          const uint8_t* tg = v.tab_grp + lv * PW_MG_MAX;
          auto stage = [&](int i, float* dst, int P) {
            if (!a.schedulable[i]) {
              for (int k = 0; k < R + ng; ++k) dst[(size_t)k * P] = 0.f;
              return;
            }
            const float* fr = free_s + (size_t)i * R;
            for (int r = 0; r < R; ++r) dst[(size_t)r * P] = fr[r];
            for (int j = 0; j < ng; ++j)
              dst[(size_t)(R + j) * P] = pw_node_slots(v, fr, gno, tg[j], i, N, R);
          };
          pw_walk_x<kShard>(a, lv, R + ng, stage, V.tables + (size_t)lv * N * (R + MG), pw_plane,
                            prof, PW_SEC_TABLES, PW_SEC_TABLES, shard, bar_gen, xpar);
        }
        for (int s2 = 0; s2 < MS; ++s2) {
          if (!v.need_table[s2]) continue;  // block-uniform
          const int lv = pw_clip(v.req_level[s2], 0, L - 1);
          const int K = R + v.tab_ng[lv];
          const float* tab = V.tables + (size_t)lv * N * (R + MG);
          for (int d = tid; d < a.dom_count[lv]; d += NT)
            V.feas2[(size_t)s2 * N + d] =
                pw_domain_fits(v, tab + (size_t)d * K, s2, v.s_tcol + s2 * PW_MG_MAX, R);
        }
        __syncthreads();
        prof.mark(PW_SEC_TABLES);
      }

      // ---- Stage 1: commit a domain per pack-set, broadest first ------------
      bool fail = false;
      for (int s = 0; s < MS; ++s) {
        const int req_lv = pw_clip(v.req_level[s], 0, L - 1);
        const int32_t* req_dom = a.node_domain_id + (size_t)req_lv * N;
        const int ng = v.s_ng[s];
        const uint8_t* sg = v.s_grp + s * PW_MG_MAX;
        const uint8_t* act = v.active2 + s * PW_MS_MAX;
        const uint8_t* ovl = v.overlap + s * PW_MS_MAX;
        int new_req = -1, new_pref = -1;
        for (int pass = 0; pass < 2; ++pass) {
          const bool nested = pass == 0;
          const int level = nested ? v.req_level[s] : v.pref_level[s];
          if (!v.svalid[s] || level < 0) continue;  // block-uniform
          const int lv = pw_clip(level, 0, L - 1);
          int n_act = 0;
          if (nested)
            for (int s2 = 0; s2 < MS; ++s2) n_act += act[s2];
          // Columns: free [R] | slots of s's member2 groups [ng] | count |
          // taken | feasibility of each active2 set (nested pass) | spread.
          const int c_cnt = R + ng, c_nest = c_cnt + 2;
          const int c_spread = c_nest + n_act;
          const int K = c_spread + (spread ? 1 : 0);
          const int extra_dom = nested ? v.pinned[s] : new_req;
          auto stage = [&](int i, float* dst, int P) {
            // node_ok / taken from the sets committed so far (only s2 < s).
            bool nok = a.schedulable[i] != 0, tk = false;
            for (int s2 = 0; s2 < s; ++s2) {
              const int c = s_creq[s2];
              if (c < 0) continue;
              const int lv2 = pw_clip(v.req_level[s2], 0, L - 1);
              const bool in_dom = a.node_domain_id[(size_t)lv2 * N + i] == c;
              if (ovl[s2]) nok = nok && in_dom;
              else if (v.svalid[s2]) tk = tk || in_dom;
            }
            if (!(nok && (extra_dom < 0 || req_dom[i] == extra_dom))) {
              for (int k = 0; k < K; ++k) dst[(size_t)k * P] = 0.f;
              return;
            }
            const float* fr = free_s + (size_t)i * R;
            for (int r = 0; r < R; ++r) dst[(size_t)r * P] = fr[r];
            for (int j = 0; j < ng; ++j)
              dst[(size_t)(R + j) * P] = pw_node_slots(v, fr, gno, sg[j], i, N, R);
            dst[(size_t)c_cnt * P] = 1.f;
            dst[(size_t)(c_cnt + 1) * P] = tk ? 1.f : 0.f;
            if (nested) {
              int c = c_nest;
              for (int s2 = 0; s2 < MS; ++s2) {
                if (!act[s2]) continue;
                const int lv2 = pw_clip(v.req_level[s2], 0, L - 1);
                const int dom = a.node_domain_id[(size_t)lv2 * N + i];
                dst[(size_t)c++ * P] = dom >= 0 && V.feas2[(size_t)s2 * N + dom] ? 1.f : 0.f;
              }
            }
            if (spread) dst[(size_t)c_spread * P] = V.spread_pen[i];
          };
          pw_walk_x<kShard>(a, lv, K, stage, V.agg, pw_plane,
                            prof, PW_SEC_S1_NODES, PW_SEC_S1_WALKS, shard, bar_gen, xpar);
          float best_v = -INFINITY;
          int best_i = INT32_MAX;
          const int D = a.dom_count[lv];
          for (int d = tid; d < D; d += NT) {
            const float* row = V.agg + (size_t)d * K;
            const float count = row[c_cnt];
            bool feasible = count > 0.f && pw_domain_fits(v, row, s, nullptr, R);
            for (int c = c_nest; feasible && c < c_spread; ++c)
              if (!(row[c] > 0.5f)) feasible = false;
            if (!feasible) continue;
            const float taken_frac = __fdiv_rn(row[c_cnt + 1], fmaxf(count, 1.f));
            float norm_free = 0.f;
            for (int r = 0; r < R; ++r) norm_free = __fadd_rn(norm_free, __fdiv_rn(row[r], cap_scale[r]));
            float sc = __fsub_rn(-norm_free, __fmul_rn(V.w_reserve, taken_frac));
            if (spread) {
              // A margin above every other score term (core.py:374-387): any
              // feasible domain with no avoided node beats one with them.
              const float big = __fadd_rn(__fadd_rn((float)(N * R), V.w_reserve), 2.f);
              const float touched = row[c_spread] > 0.5f ? 1.f : 0.f;
              sc = __fsub_rn(sc, __fmul_rn(V.w_spread > 0.f ? big : 0.f, touched));
            }
            if (pw_better(sc, d, best_v, best_i)) { best_v = sc; best_i = d; }
          }
          // Every thread reads the winner before the next argmax's first
          // barrier, after which alone it is written again.
          pw_block_argmax(best_v, best_i, red_v, red_i, &s_best_v, &s_best_i);
          const bool any = s_best_v > -INFINITY;
          if (nested) {
            new_req = any ? s_best_i : -1;
            fail = fail || !any;
          } else {
            new_pref = any ? s_best_i : -1;
          }
          prof.mark(PW_SEC_S1_ARGMAX);
        }
        if (new_req >= 0 || new_pref >= 0) {  // block-uniform
          if (tid == 0) { s_creq[s] = new_req; s_cpref[s] = new_pref; }
          __syncthreads();
          prof.mark(PW_SEC_S1_ARGMAX);
        }
      }

      // ---- Stage 2: allocate counts per group, floors first, then extras ----
      // Each node's word: its committed-domain bits (bit s: inside set s's
      // committed required / preferred domain), schedulable, the gang's reuse
      // seed (then every node it takes) and the spread penalty.
      unsigned committed = 0;
      for (int s = 0; s < MS; ++s)
        if (s_creq[s] >= 0) committed |= 1u << s;
      for (int i = row_lo + tid; i < row_hi; i += NT) {
        unsigned in_req = 0, in_pref = 0;
        for (int s = 0; s < MS; ++s) {
          const int cr = s_creq[s], cp = s_cpref[s];
          if (cr >= 0 && a.node_domain_id[(size_t)pw_clip(v.req_level[s], 0, L - 1) * N + i] == cr)
            in_req |= 1u << s;
          if (cp >= 0 && a.node_domain_id[(size_t)pw_clip(v.pref_level[s], 0, L - 1) * N + i] == cp)
            in_pref |= 1u << s;
        }
        unsigned w = in_req | in_pref << 8;
        if (a.schedulable[i]) w |= PW_NW_SCHED;
        if (a.reuse_nodes && a.reuse_nodes[(size_t)gi * N + i]) w |= PW_NW_USED;
        if (spread && V.spread_pen[i] > 0.5f) w |= PW_NW_SPREAD;  // spread_pen is 0 or 1
        V.nword[i] = (int32_t)w;
      }
      bool groups_ok = true;
      int32_t* ent = V.entries;
      for (int t = 0; t < 2 * MG; ++t) {
        const int g = v.order[t % MG];
        const int phase = t / MG;
        const int total = phase == 0 ? v.required[g] : v.total[g] - v.required[g];
        // Block-uniform: an invalid group, or a phase with nothing to place,
        // takes no node and leaves every count 0.
        if (!v.gvalid[g] || total <= 0) continue;
        const int floor_req = phase == 0 ? v.required[g] : 0;
        const float* req = v.req + g * PW_R_MAX;
        const unsigned mb = v.memb_bits[g];
        // The node words and the last phase's takes are in place, and nobody
        // still reads the last phase's warp bests.
        __syncthreads();
        float bv = -INFINITY;
        int bi = INT32_MAX;
  #pragma unroll 4
        for (int i = row_lo + tid; i < row_hi; i += NT) {
          const unsigned w = (unsigned)V.nword[i];
          bool nok = (w & PW_NW_SCHED) && (mb & committed & ~w & 0xffu) == 0;
          if (nok && gno) nok = gno[(size_t)g * N + i] != 0;
          int sl = 0;
          if (nok) {
            sl = pw_slots(free_s + (size_t)i * R, req, R);
            sl = sl < total ? sl : total;
          }
          V.a_slots[i] = sl;
          if (sl <= 0) continue;  // never a candidate: its score is never read
          const unsigned in_req = w & 0xffu, in_pref = (w >> 8) & 0xffu;
          // pref_bonus and reserved are counts of 1.0 added in set order: exact.
          const float pref_bonus = (float)pw_popc(in_pref & mb);
          const float reserved = (float)pw_popc(in_req & ~mb);
          float sc = __fadd_rn(__fmul_rn(V.w_pref, pref_bonus),
                               __fmul_rn(V.w_reuse, (w & PW_NW_USED) ? 1.f : 0.f));
          sc = __fsub_rn(sc, __fmul_rn(V.w_tight, V.norm_free[i]));
          sc = __fsub_rn(sc, __fmul_rn(V.w_reserve, reserved));
          if (spread) sc = __fsub_rn(sc, __fmul_rn(V.w_spread, (w & PW_NW_SPREAD) ? 1.f : 0.f));
          V.a_score[i] = sc;
          if (pw_better(sc, i, bv, bi)) { bv = sc; bi = i; }
        }
        pw_warp_argmax(bv, bi);
        if (lane == 0) { wb_v[0][warp] = bv; wb_i[0][warp] = bi; }
        if (tid == 0) { s_rem[0] = total; s_ncand = 0; }
        __syncthreads();
        prof.mark(PW_SEC_S2_SCORE);
        // The sharded launch: the shard's candidates, in its own best-first
        // order, until their slots cover the phase's total.
        int32_t* xc = kShard ? a.xcand + ((size_t)xpar * a.S + shard) * a.x_rows * 3 : nullptr;
        // Top-k as iterated argmax: the best node by (score desc, index asc)
        // takes min(slots, remaining) until the phase's total is placed. Only
        // the warp that owns the taken node rescans; one barrier per take.
        int rem = total;
        for (int it = 0;; ++it) {
          const int cur = it & 1, nxt = cur ^ 1;
          rem = s_rem[cur];
          if (rem <= 0) break;
          // Every warp reduces the warps' bests itself: one load a lane.
          float bv2 = -INFINITY;
          int node = INT32_MAX;
          for (int w = lane; w < NW; w += PW_WARP)
            if (pw_better(wb_v[cur][w], wb_i[cur][w], bv2, node)) { bv2 = wb_v[cur][w]; node = wb_i[cur][w]; }
          pw_warp_argmax(bv2, node);
          if (node == INT32_MAX) break;  // block-uniform: no node has slots left
          if (warp == ((node - row_lo) % NT) / PW_WARP) {
            if (kShard && lane == 0) {
              const int sl = V.a_slots[node];
              s_rem[nxt] = rem - sl;
              V.a_slots[node] = 0;
              int32_t* c = xc + 3 * s_ncand++;
              c[0] = node;
              c[1] = sl;
              c[2] = pw_f2i(V.a_score[node]);
            } else if (lane == 0) {
              const int sl = V.a_slots[node];
              const int take = sl < rem ? sl : rem;
              s_rem[nxt] = rem - take;
              V.a_slots[node] = 0;
              const int e = s_n_entries++;
              ent[3 * e] = g;
              ent[3 * e + 1] = node;
              ent[3 * e + 2] = take;
              for (int r = 0; r < R; ++r) {
                const float x = free_s[(size_t)node * R + r];
                V.undo[(size_t)e * R + r] = x;
                free_s[(size_t)node * R + r] = __fsub_rn(x, __fmul_rn((float)take, req[r]));
              }
              V.norm_free[node] = pw_norm_free(free_s + (size_t)node * R, cap_scale, R);
              V.nword[node] |= (int32_t)PW_NW_USED;
            }
            pw_syncwarp();
            float wv = -INFINITY;
            int wi = INT32_MAX;
            for (int i = row_lo + tid; i < row_hi; i += NT)
              if (V.a_slots[i] > 0 && pw_better(V.a_score[i], i, wv, wi)) { wv = V.a_score[i]; wi = i; }
            pw_warp_argmax(wv, wi);
            if (lane == 0) { wb_v[nxt][warp] = wv; wb_i[nxt][warp] = wi; }
          } else if (lane == 0) {
            wb_v[nxt][warp] = wb_v[cur][warp];
            wb_i[nxt][warp] = wb_i[cur][warp];
          }
          __syncthreads();
        }
        if constexpr (kShard) {
          // Exchange the candidates; every shard merges the S lists by
          // (score desc, node asc) and takes down the merged order,
          // changing its own rows only. Every shard logs every entry.
          if (tid == 0) a.xcnt[xpar * a.S + shard] = s_ncand;
          pw_grid_sync(a, bar_gen);
          if (tid == 0) {
            const int32_t* xb = a.xcand + (size_t)xpar * a.S * a.x_rows * 3;
            int head[PW_S_MAX], cnt[PW_S_MAX];
            for (int s = 0; s < a.S; ++s) { head[s] = 0; cnt[s] = PW_LDCG(a.xcnt + xpar * a.S + s); }
            int r2 = total;
            while (r2 > 0) {
              int bs = -1, bn = INT32_MAX;
              float bv = -INFINITY;
              for (int s = 0; s < a.S; ++s) {
                if (head[s] >= cnt[s]) continue;
                const int32_t* c = xb + ((size_t)s * a.x_rows + head[s]) * 3;
                const int cn = PW_LDCG(c);
                const float cv = pw_i2f(PW_LDCG(c + 2));
                if (bs < 0 || pw_better(cv, cn, bv, bn)) { bs = s; bn = cn; bv = cv; }
              }
              if (bs < 0) break;  // no shard has a candidate left
              const int sl = PW_LDCG(xb + ((size_t)bs * a.x_rows + head[bs]) * 3 + 1);
              ++head[bs];
              const int take = sl < r2 ? sl : r2;
              r2 -= take;
              const int e = s_n_entries++;
              ent[3 * e] = g;
              ent[3 * e + 1] = bn;
              ent[3 * e + 2] = take;
              if (bn >= row_lo && bn < row_hi) {
                for (int r = 0; r < R; ++r) {
                  const float x = free_s[(size_t)bn * R + r];
                  V.undo[(size_t)e * R + r] = x;
                  free_s[(size_t)bn * R + r] = __fsub_rn(x, __fmul_rn((float)take, req[r]));
                }
                V.norm_free[bn] = pw_norm_free(free_s + (size_t)bn * R, cap_scale, R);
                V.nword[bn] |= (int32_t)PW_NW_USED;
              }
            }
            s_rem[0] = r2;
          }
          __syncthreads();
          rem = s_rem[0];
          xpar ^= 1;
        }
        if (total - rem < floor_req) groups_ok = false;
        prof.mark(PW_SEC_S2_TAKE);
      }
      __syncthreads();  // entries and the last takes are in place

      const bool gang_ok = groups_ok && !fail;  // valid holds here
      const int n_ent = s_n_entries;

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
        if (node >= 0 && spread && v.spread_family >= 0)
          V.family_used[(size_t)pw_clip(v.spread_family, 0, a.G - 1) * N + node] = 1;
        // B3 remap (remap_assigned): candidate ordinal -> fleet ordinal.
        if (node >= 0 && pruned) node = a.cand_idx[pw_clip(node, 0, a.cand_count - 1)];
        V.assigned[(size_t)gi * MP + p] = node;
      }

      // ---- Stage 4: placement quality -----------------------------------------
      if (tid == 0) {
        float sum = 0.f;
        int n_pref = 0;
        for (int s = 0; s < MS; ++s) {
          const int lvl = v.pref_level[s];
          const int cp = s_cpref[s];
          const bool active = lvl >= 0;
          float f = active ? 0.f : 1.f;
          if (active && cp >= 0) {
            const int pl = pw_clip(lvl, 0, L - 1);
            float tot = 0.f, hits = 0.f;
            for (int e = 0; e < n_ent; ++e) {
              if (!v.member[s * PW_MG_MAX + ent[3 * e]]) continue;
              const float c = (float)ent[3 * e + 2];
              tot = __fadd_rn(tot, c);
              if (a.node_domain_id[(size_t)pl * N + ent[3 * e + 1]] == cp) hits = __fadd_rn(hits, c);
            }
            f = tot > 0.f ? __fdiv_rn(hits, fmaxf(tot, 1.f)) : 1.f;
          }
          if (v.svalid[s] && active) {
            sum = __fadd_rn(sum, f);
            n_pref += 1;
          } else {
            sum = __fadd_rn(sum, 0.f);
          }
        }
        const float mean = n_pref > 0 ? __fdiv_rn(sum, (float)n_pref) : 1.f;
        V.score[gi] = gang_ok ? __fadd_rn(0.5f, __fmul_rn(0.5f, mean)) : 0.f;
        V.ok[gi] = gang_ok ? 1 : 0;
      }
      if (kProfile) __syncthreads();
      prof.mark(PW_SEC_S34);

      // ---- all-or-nothing: a rejected gang puts back every row it took -------
      if (!gang_ok && tid == 0) {
        // (a shard logged undo rows for its own nodes only)
        for (int e = n_ent - 1; e >= 0; --e) {
          const int node = ent[3 * e + 1];
          if (node < row_lo || node >= row_hi) continue;
          for (int r = 0; r < R; ++r) free_s[(size_t)node * R + r] = V.undo[(size_t)e * R + r];
        }
        for (int e = 0; e < n_ent; ++e) {
          const int node = ent[3 * e + 1];
          if (node < row_lo || node >= row_hi) continue;
          V.norm_free[node] = pw_norm_free(free_s + (size_t)node * R, cap_scale, R);
        }
      }
      __syncthreads();
      prof.mark(PW_SEC_COMMIT);
    }

    if (kProfile) prof.row = a.prof + (size_t)a.G * PW_NSEC;
    if (pruned) {
      // B3 scatter (scatter_free): candidate rows back to the fleet; pad rows
      // drop; the plan's indices are unique, so no two threads share a row.
      for (int k = row_lo * R + tid; k < row_hi * R; k += NT) {
        const int dst = a.cand_idx[k / R];
        if (dst >= 0 && dst < a.NF) a.free_io[(size_t)dst * R + k % R] = free_s[k];
      }
    }
    // ---- B2 scatter-max of this wave's verdicts into ok_global ---------------
    // (the stacked launch leaves it to the select, or to nobody)
    if (!kStacked && a.T > 0 && shard == 0) {
      for (int gi = tid; gi < a.G; gi += NT) {
        const int gidx = a.global_index[gi];
        if (gidx >= 0 && V.ok[gi]) a.ok_global[pw_clip(gidx, 0, a.T - 1)] = 1;
      }
    }
    if (kProfile) {
      __syncthreads();
      prof.mark(PW_SEC_COMMIT);
    }
  }  // step
}

// ---- portfolio select: the winner among the stacked launch's rows ----------

// sum(x[0..n)) in the order XLA's CPU backend sums a reduction of n f32
// values (its tree-reduction rewrite, as the JAX package's `_objective` runs
// it): while n >= 32, the values are padded with zeros to a multiple of 32 —
// half the padding, rounded down, in front and the rest behind — and each
// window of 32 is summed in index order into one value; the fewer than 32
// values left are summed in index order. Overwrites x.
__device__ float pw_xla_sum(float* x, int n) {
  while (n >= 32) {
    const int pad = (32 - n % 32) % 32, lo = pad / 2, m = (n + pad) / 32;
    for (int j = 0; j < m; ++j) {
      float acc = 0.f;  // a padding zero adds nothing
      for (int p = 32 * j - lo; p < 32 * j - lo + 32; ++p)
        if (p >= 0 && p < n) acc = __fadd_rn(acc, x[p]);
      x[j] = acc;  // every later window starts past x[j]
    }
    n = m;
  }
  float acc = 0.f;
  for (int p = 0; p < n; ++p) acc = __fadd_rn(acc, x[p]);
  return acc;
}

// One block, after the K chains (grove_tpu/parallel/portfolio.py
// `_objective` and `portfolio_solve_batch`): per row its admitted count and
// its quality, the sum of the admitted gangs' placement scores; the winner
// has the most admitted gangs, then the highest quality, then the lowest
// index. Its rows are copied out, its carry becomes the fleet's, and its
// verdicts are scatter-maxed into ok_global (B2), as the single launch does.
__global__ void place_wave_select(const PlaceWaveArgs a) {
  __shared__ int s_win;
  const int tid = threadIdx.x, NT = blockDim.x;
  const int G = a.G, K = a.K;
  for (int k = tid; k < K; k += NT) {
    const uint8_t* ok = a.ok + (size_t)k * G;
    const float* sc = a.score + (size_t)k * G;
    float* terms = a.sel_terms + (size_t)k * G;
    int adm = 0;
    for (int g = 0; g < G; ++g) {
      adm += ok[g] != 0;
      terms[g] = ok[g] ? sc[g] : 0.f;
    }
    const float q = pw_xla_sum(terms, G);
    a.sel_admitted[k] = adm;
    a.sel_quality[k] = q;
    a.objectives[k] = __fadd_rn(__fmul_rn((float)adm, 1e6f), q);
  }
  __syncthreads();
  if (tid == 0) {
    int best = a.sel_admitted[0];
    for (int k = 1; k < K; ++k) best = a.sel_admitted[k] > best ? a.sel_admitted[k] : best;
    int w = -1;
    for (int k = 0; k < K; ++k)
      if (a.sel_admitted[k] == best && (w < 0 || a.sel_quality[k] > a.sel_quality[w])) w = k;
    s_win = w;
    *a.winner = w;
  }
  __syncthreads();
  const size_t w = s_win;
  const int MP = a.MP, NR = a.N * a.R;
  for (int i = tid; i < G * MP; i += NT) a.win_assigned[i] = a.assigned[w * G * MP + i];
  for (int i = tid; i < G; i += NT) {
    const uint8_t okw = a.ok[w * G + i];
    a.win_ok[i] = okw;
    a.win_score[i] = a.score[w * G + i];
    const int gidx = a.global_index[i];
    if (a.T > 0 && gidx >= 0 && okw) a.ok_global[pw_clip(gidx, 0, a.T - 1)] = 1;
  }
  for (int i = tid; i < NR; i += NT) a.free_io[i] = a.carry[w * NR + i];
}

// Launch one wave on `stream`: the prologue (one one-thread block per gang:
// its loops are short and serial, and G blocks fill the idle SMs), then the
// chain kernel with `smem_bytes` = 4 * plane_words of dynamic shared memory.
// `profile` picks the instantiation that times its sections into args->prof.
// Returns cudaGetLastError() (0 = launched).
//
// The stacked launch: the prologue, K chain blocks (one per weight row), and
// with `select` the select kernel.
//
// The scan launch: the scan's prologue over the W * G gangs, then one chain
// block over the W steps. The sweep launch: the same prologue, then W * K
// chain blocks.
#ifndef PLACE_WAVE_HOST_EMULATION
template <bool kProfile, bool kStacked, bool kScan = false>
static int pw_launch(const PlaceWaveArgs* args, cudaStream_t stream, int smem_bytes) {
  if (kScan && args->G > 0 && args->W > 0)
    place_wave_scan_prologue<<<args->W * args->G, 1, 0, stream>>>(*args);
  else if (!kScan && args->G > 0)
    place_wave_prologue<<<args->G, 1, 0, stream>>>(*args);
  cudaError_t err = cudaFuncSetAttribute(place_wave_kernel<kProfile, kStacked, kScan>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  place_wave_kernel<kProfile, kStacked, kScan>
      <<<kStacked ? (kScan ? args->W * args->K : args->K) : 1, PW_THREADS, smem_bytes,
         stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int place_wave_launch(const PlaceWaveArgs* args, void* stream, int smem_bytes,
                                 int profile) {
  cudaStream_t st = (cudaStream_t)stream;
  return profile ? pw_launch<true, false>(args, st, smem_bytes)
                 : pw_launch<false, false>(args, st, smem_bytes);
}

extern "C" int place_wave_stacked_launch(const PlaceWaveArgs* args, void* stream, int smem_bytes,
                                         int select) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = pw_launch<false, true>(args, st, smem_bytes);
  if (err != 0 || !select) return err;
  place_wave_select<<<1, PW_THREADS, 0, st>>>(*args);
  return (int)cudaGetLastError();
}

// The select kernel alone, on the rows a stacked launch left in `args`'
// arrays (chip_smoke.py times it so).
extern "C" int place_wave_select_launch(const PlaceWaveArgs* args, void* stream) {
  place_wave_select<<<1, PW_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int place_wave_scan_launch(const PlaceWaveArgs* args, void* stream, int smem_bytes) {
  return pw_launch<false, false, true>(args, (cudaStream_t)stream, smem_bytes);
}

extern "C" int place_wave_sweep_launch(const PlaceWaveArgs* args, void* stream, int smem_bytes) {
  return pw_launch<false, true, true>(args, (cudaStream_t)stream, smem_bytes);
}

// The sharded launch (B7): the prologue, then S chain blocks launched
// cooperatively, so that all S are resident for the barriers.
extern "C" int place_wave_sharded_launch(const PlaceWaveArgs* args, void* stream, int smem_bytes) {
  cudaStream_t st = (cudaStream_t)stream;
  if (args->S < 1 || args->S > PW_S_MAX) return (int)cudaErrorInvalidValue;
  if (args->G > 0) place_wave_prologue<<<args->G, 1, 0, st>>>(*args);
  void (*kern)(const PlaceWaveArgs) = place_wave_kernel<false, false, false, true>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  PlaceWaveArgs a = *args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(args->S), dim3(PW_THREADS), params,
                                    (size_t)smem_bytes, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#else
// The same launches for a one-thread block on the host (the CPU tests): the
// prologue gang by gang, then the chain (block by block when stacked).
extern "C" int place_wave_launch(const PlaceWaveArgs* args, void*, int, int profile) {
  for (int gi = 0; gi < args->G; ++gi) pw_gang_invariants(*args, gi);
  if (profile) place_wave_kernel<true, false, false>(*args);
  else place_wave_kernel<false, false, false>(*args);
  return 0;
}

extern "C" int place_wave_stacked_launch(const PlaceWaveArgs* args, void*, int, int select) {
  for (int gi = 0; gi < args->G; ++gi) pw_gang_invariants(*args, gi);
  for (pw_emu_block = 0; pw_emu_block < args->K; ++pw_emu_block)
    place_wave_kernel<false, true, false>(*args);
  pw_emu_block = 0;
  if (select) place_wave_select(*args);
  return 0;
}

extern "C" int place_wave_select_launch(const PlaceWaveArgs* args, void*) {
  place_wave_select(*args);
  return 0;
}

extern "C" int place_wave_scan_launch(const PlaceWaveArgs* args, void*, int) {
  for (int b = 0; b < args->W * args->G; ++b) pw_scan_invariants(*args, b);
  place_wave_kernel<false, false, true>(*args);
  return 0;
}

extern "C" int place_wave_sweep_launch(const PlaceWaveArgs* args, void*, int) {
  for (int b = 0; b < args->W * args->G; ++b) pw_scan_invariants(*args, b);
  for (pw_emu_block = 0; pw_emu_block < args->W * args->K; ++pw_emu_block)
    place_wave_kernel<false, true, true>(*args);
  pw_emu_block = 0;
  return 0;
}

// The sharded launch's S blocks meet at barriers, so each runs on a thread
// of its own (the shim's walk plane must then be thread_local).
extern "C" int place_wave_sharded_launch(const PlaceWaveArgs* args, void*, int) {
  if (args->S < 1 || args->S > PW_S_MAX) return 1;
  for (int gi = 0; gi < args->G; ++gi) pw_gang_invariants(*args, gi);
  std::vector<std::thread> shards;
  for (int s = 0; s < args->S; ++s)
    shards.emplace_back([args, s] {
      pw_emu_block = s;
      place_wave_kernel<false, false, false, true>(*args);
    });
  for (auto& t : shards) t.join();
  return 0;
}
#endif

extern "C" int place_wave_args_size() { return (int)sizeof(PlaceWaveArgs); }
extern "C" int place_wave_inv_size() { return (int)sizeof(PwGangInv); }
