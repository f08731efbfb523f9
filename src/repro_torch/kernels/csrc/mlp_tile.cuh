// mlp_tile: the ReLU MLP over a tile of rows per block, its weights
// streamed through shared memory.  K3 and K5 (fused_mlp.cu) and K6
// (fused_dag.cu) run it for models past one chunk (RT_MLP_CHUNK weights);
// smaller ones, and K1, run mlp_argmax.cuh (one warp a row).  Replaces the
// batch-tile schedule of the TPU's fused_mlp kernels
// (repro/kernels/fused_mlp/kernel.py:59 _kernel, :71 _classify_kernel,
// :158 _dag_kernel): a tile of rows goes through the model one layer at a
// time, each layer one product over the whole tile.
//
// Bound: operations.  [7, 128 x 10, 2] is 148,608 weights (594 KB) and
// about 297 kFLOP a row, so 1,024 rows take at least 0.0045 ms at the
// card's 67 TFLOP/s (f32, CUDA cores) against 0.0009 ms for their bytes.
// The weights do not fit in shared memory beside a useful tile, so what a
// design controls is how often each weight crosses from L2 and how many
// FMAs each shared-memory load feeds.
//
// The design:
// - A block takes a tile of R rows (at most RT_MLP_TILE_ROWS): the input
//   rows in one buffer, the activations ping-ponging between two
//   [R x p_h] buffers, one layer at a time with a __syncthreads() between
//   layers.
// - The weights stream through a ring of MT_STAGES stages of up to
//   RT_MLP_CHUNK floats, two chunks in flight while one is multiplied.  A
//   chunk is a run of whole weight rows in packing order, so it may end
//   one layer and start the next, or the next model's; the biases of the
//   layers that end in a chunk ride in its stage.  A producer warp beside
//   the RT_WARPS multiplying ones brings each chunk in with two bulk
//   copies (cp.async.bulk, the TMA) on the stage's mbarrier: 16-byte
//   cp.async from every thread kept too few bytes in flight to feed the
//   multiply.  A copy runs from the 16-byte boundary at or before its
//   first float to the one at or after its last, so it never leaves the
//   16-byte granules of the array.
// - R is the power of two >= ceil(B / the SM count), at most
//   RT_MLP_TILE_ROWS, so the grid fills the card's SMs where B allows
//   (B = 128: 128 blocks of one row).  Every block reads each weight once
//   a tile, so L2 serves B / R x 594 KB; a grid of half as many blocks
//   halves that but doubles each block's FMAs, and on the H100 it was
//   no faster at any B from 128 to 1,024: an SM's own intake, not L2,
//   bounds the stream.
// - Each multiplying warp owns a register tile of TR rows x TO groups of
//   32 outputs (mt_map, per layer): lane o reads weight row i at o (one
//   conflict-free shared load feeds TR FMAs) and the TR activations are
//   broadcasts, four input indices at a load; the next four are loaded
//   before this four's FMAs.
// - The same bits as mlp_argmax.cuh: each output is one fmaf chain over
//   ascending input index from 0, then the bias, then ReLU on all but the
//   last layer; the argmax is the same warp reduction (ties to the lowest
//   index).  f32 FMA on the CUDA cores: no tensor cores (TF32 would move
//   the logits), no cuBLAS.
#pragma once

#include <math.h>
#include <stdint.h>

#include "rt_types.h"

// RT_WARPS warps multiply; one more brings the weights in
#define MT_WARPS (RT_WARPS + 1)
#define MT_THREADS (MT_WARPS * 32)
#define MT_LOG_WARPS 3           // log2(RT_WARPS)
#define MT_STAGES 3              // stages of the weight ring
#define MT_ACC 32                // accumulators of a thread (TR x TO)
#define MT_SMEM_MAX (227 * 1024 - 1024)   // dynamic, beside the static

// The models of one launch, in packing order: weights and biases of
// model 0's layers, then model 1's, ... back to back.
struct MtModels {
  int n;
  int nl[RT_DAG_MAX_MODELS];
  int w[RT_DAG_MAX_MODELS][RT_MAX_LAYERS + 1];
};

// A launch's tile: R rows; pitches (floats, multiples of 4) of the input
// tile and of the activation buffers; ring stage size, where a stage's
// biases start, and the stage count.
struct MtCfg {
  int R, p_in, p_h, stg, bst, n_stg;
};

// The next weight row of the stream: model m, layer l, input index i,
// float offset f in the packed weights, bo of the layer's biases.
struct MtCursor {
  int m, l, i, f, bo;
};

// Where the chunk that starts at c ends: whole rows while they fit in
// RT_MLP_CHUNK floats (a split layer breaks at a multiple of 4 rows).
__host__ __device__ inline MtCursor mt_chunk_end(const MtModels& s,
                                                 MtCursor c) {
  const int cap = RT_MLP_CHUNK;
  int used = 0;
  while (c.m < s.n) {
    const int din = s.w[c.m][c.l];
    const int dout = s.w[c.m][c.l + 1];
    const int left = din - c.i;
    if (used + left * dout <= cap) {
      used += left * dout;
      c.f += left * dout;
      c.bo += dout;
      c.i = 0;
      if (++c.l == s.nl[c.m]) {
        c.l = 0;
        ++c.m;
      }
      continue;
    }
    int fit = (cap - used) / dout;
    if (fit >= 4) fit &= ~3;
    c.i += fit;
    c.f += fit * dout;
    break;
  }
  return c;
}

__device__ __forceinline__ uint32_t mt_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mt_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mt_smem(bar))
               : "memory");
}

// Wait for the phase of the given parity of a stage's mbarrier.
__device__ __forceinline__ void mt_bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mt_smem(bar)), "r"(parity)
        : "memory");
}

// One bulk copy of floats [lo, hi) of src (16-byte aligned) to dst, whose
// float 0 is src's float (lo & ~3), counted on bar.  -> bytes.
__device__ __forceinline__ uint32_t mt_bulk(float* dst, const float* src,
                                            int lo, int hi, uint64_t* bar) {
  const int a = lo & ~3;
  const uint32_t bytes = 4u * (((hi + 3) & ~3) - a);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(mt_smem(dst)),
      "l"(src + a), "r"(bytes), "r"(mt_smem(bar))
      : "memory");
  return bytes;
}

// Bring the chunk [c, e) into a stage (one thread): its weights, and the
// biases of the layers that end in it at stage + bst.
__device__ __forceinline__ void mt_fetch(float* stage, int bst, uint64_t* bar,
                                         const float* w, const float* b,
                                         const MtCursor& c,
                                         const MtCursor& e) {
  uint32_t bytes = 4u * (((e.f + 3) & ~3) - (c.f & ~3));
  if (e.bo > c.bo) bytes += 4u * (((e.bo + 3) & ~3) - (c.bo & ~3));
  // the stage's last readers are done: the block synchronised since
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(mt_smem(bar)), "r"(bytes)
               : "memory");
  mt_bulk(stage, w, c.f, e.f, bar);
  if (e.bo > c.bo) mt_bulk(stage + bst, b, c.bo, e.bo, bar);
}

// A warp's share of a layer: rows [rbase, rbase + tr), outputs
// o0 + 32 t for t < to.
struct MtMap {
  int tr, to, rbase, o0;
  bool active;
};

// Spread a layer's R x ceil(dout / 32) warp-units over the RT_WARPS
// multiplying warps: up to 8 rows a warp, then more output groups.  All
// counts are powers of two, held as their logs (lr = log2 R).
__device__ __forceinline__ MtMap mt_map(int lr, int dout, int warp,
                                        int lane) {
  static_assert((1 << MT_LOG_WARPS) == RT_WARPS, "MT_LOG_WARPS");
  int lj = 0;                      // output groups of 32, rounded up
  while ((32 << lj) < dout) ++lj;
  const int lu = max(0, lr + lj - MT_LOG_WARPS);  // units a warp
  const int lto = min(lj, max(0, lu - 3));        // to = units / 8
  const int ltr = lu - lto;
  const int lwo = lj - lto;        // warps along the outputs
  const int lrg = lr - ltr;        // warps along the rows
  MtMap m;
  m.tr = 1 << ltr;
  m.to = 1 << lto;
  m.active = warp < (1 << (lwo + lrg));
  m.rbase = (warp >> lwo) << ltr;
  m.o0 = ((warp & ((1 << lwo) - 1)) << (lto + 5)) + lane;
  return m;
}

// CALL(TR, TO) for the map's instance: (1..8, 1), (8, 2) or (8, 4).  A
// chain of direct branches (a switch became a jump table read from the
// constant bank on every layer).
#define MT_DISPATCH(map, CALL)                                           \
  if ((map).to == 4) {                                                  \
    CALL(8, 4);                                                         \
  } else if ((map).to == 2) {                                           \
    CALL(8, 2);                                                         \
  } else if ((map).tr == 8) {                                           \
    CALL(8, 1);                                                         \
  } else if ((map).tr == 4) {                                           \
    CALL(4, 1);                                                         \
  } else if ((map).tr == 2) {                                           \
    CALL(2, 1);                                                         \
  } else {                                                              \
    CALL(1, 1);                                                         \
  }

// acc[k * TO + t] += h[rbase + k][i] * w[i][o0 + 32 t] for i in [i0, i1),
// one fmaf at a time in ascending i.  ws: weight row i0; h: row rbase.
// Four input indices a step (the activations as float4 broadcasts), two
// register sets taking turns so that a step's loads are in flight during
// the previous step's FMAs.  A lane past dout reads column dout - 1 and
// its sums are never written.
template <int TR, int TO>
__device__ __forceinline__ void mt_piece(float* acc, const float* h, int P,
                                         const float* ws, int dout, int i0,
                                         int i1, int o0) {
  int col[TO];
#pragma unroll
  for (int t = 0; t < TO; ++t) col[t] = min(o0 + 32 * t, dout - 1);
  auto step1 = [&](int i) {
    const float* wr = ws + (i - i0) * dout;
#pragma unroll
    for (int t = 0; t < TO; ++t) {
      const float wv = wr[col[t]];
#pragma unroll
      for (int k = 0; k < TR; ++k)
        acc[k * TO + t] = fmaf(h[k * P + i], wv, acc[k * TO + t]);
    }
  };
  int i = i0;
  for (; i < i1 && (i & 3); ++i) step1(i);
  const int n4 = (i1 - i) >> 2;
  if (n4 > 0) {
    const float* wr = ws + (i - i0) * dout;
    const float* hr = h + i;
    const int d4 = 4 * dout;
    float wa[4][TO], wb[4][TO];
    float4 ha[TR], hb[TR];
    auto load = [&](float (&w4)[4][TO], float4 (&h4)[TR]) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < TO; ++t) w4[q][t] = wr[q * dout + col[t]];
#pragma unroll
      for (int k = 0; k < TR; ++k)
        h4[k] = *reinterpret_cast<const float4*>(hr + k * P);
      wr += d4;
      hr += 4;
    };
    auto fma4 = [&](const float (&w4)[4][TO], const float4 (&h4)[TR]) {
#pragma unroll
      for (int k = 0; k < TR; ++k)
#pragma unroll
        for (int t = 0; t < TO; ++t) {
          float a = acc[k * TO + t];
          a = fmaf(h4[k].x, w4[0][t], a);
          a = fmaf(h4[k].y, w4[1][t], a);
          a = fmaf(h4[k].z, w4[2][t], a);
          a = fmaf(h4[k].w, w4[3][t], a);
          acc[k * TO + t] = a;
        }
    };
    load(wa, ha);
    int n = 1;
    for (; n + 1 < n4; n += 2) {
      load(wb, hb);
      fma4(wa, ha);
      load(wa, ha);
      fma4(wb, hb);
    }
    if (n < n4) {
      load(wb, hb);
      fma4(wa, ha);
      fma4(wb, hb);
    } else {
      fma4(wa, ha);
    }
    i += 4 * n4;
  }
  for (; i < i1; ++i) step1(i);
}

// dst[rbase + k][o] = relu?(acc + bias[o]).
template <int TR, int TO>
__device__ __forceinline__ void mt_finish(const float* acc, float* dst,
                                          int P, const float* bias,
                                          int dout, bool relu, int o0) {
#pragma unroll
  for (int t = 0; t < TO; ++t) {
    const int o = o0 + 32 * t;
    if (o >= dout) continue;
    const float bv = bias[o];
#pragma unroll
    for (int k = 0; k < TR; ++k) {
      float v = acc[k * TO + t] + bv;
      if (relu) v = fmaxf(v, 0.f);
      dst[k * P + o] = v;
    }
  }
}

// The class id of one row of logits on every lane: mlp_argmax's warp
// reduction (ties to the lowest index).
__device__ __forceinline__ int mt_argmax(const float* logits, int n_cls,
                                         int lane) {
  float best = -INFINITY;
  int idx = 0x7fffffff;
  if (lane < n_cls) {
    best = logits[lane];
    idx = lane;
  }
  for (int o = lane + 32; o < n_cls; o += 32) {
    const float v = logits[o];
    if (v > best) {
      best = v;
      idx = o;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}

// Run rows [row0, row0 + nr) of x through every model of s.  After each
// model's last layer the whole block calls head(m, logits, pitch) on the
// tile's logits (rows [0, nr) valid), synchronised before and after.
// smem: the ring, the input tile, the two activation buffers (mt_config).
template <class Head>
__device__ __forceinline__ void mt_tile(const MtModels& s, const MtCfg& c,
                                        const float* x, int row0, int nr,
                                        const float* w, const float* b,
                                        float* smem, Head&& head) {
  __shared__ uint64_t bar[MT_STAGES];
  __shared__ MtModels sm;            // the models, read on every chunk
  __shared__ MtCursor ends[MT_STAGES];  // where each stage's chunk ends
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lr = __ffs(c.R) - 1;
  const bool producer = tid == RT_WARPS * 32;
  float* ring = smem;
  float* xs = ring + c.n_stg * c.stg;
  float* hb0 = xs + c.R * c.p_in;
  float* hb1 = hb0 + c.R * c.p_h;
  {
    const int* src = reinterpret_cast<const int*>(&s);
    int* dst = reinterpret_cast<int*>(&sm);
    for (int k = tid; k < (int)(sizeof(MtModels) / sizeof(int));
         k += MT_THREADS)
      dst[k] = src[k];
  }
  MtCursor pc{0, 0, 0, 0, 0};        // the next chunk to fetch
  MtCursor cc{0, 0, 0, 0, 0};        // the next row to multiply
  // The producer warp's first thread fetches: the chunk's end goes to
  // ends[] before the arrive (release), so a thread that sees the chunk
  // land sees it too.
  auto fetch = [&](const MtModels& m, int k) {
    const MtCursor e = mt_chunk_end(m, pc);
    ends[k] = e;
    mt_fetch(ring + k * c.stg, c.bst, bar + k, w, b, pc, e);
    pc = e;
  };
  if (producer) {                    // the first chunks fly meanwhile
    for (int k = 0; k < MT_STAGES; ++k) mt_bar_init(bar + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < MT_STAGES - 1 && pc.m < s.n; ++k) fetch(s, k);
  }
  const int d0 = s.w[0][0];
  for (int e = tid; e < c.R * d0; e += MT_THREADS) {
    const int r = e / d0, col = e - r * d0;
    xs[r * c.p_in + col] =
        r < nr ? __ldg(x + (size_t)(row0 + r) * d0 + col) : 0.f;
  }
  __syncthreads();                   // models, barriers, input tile
  float acc[MT_ACC];
  MtMap map{1, 1, 0, 0, false};
  for (int chunk = 0; cc.m < sm.n; ++chunk) {
    const int k = chunk % MT_STAGES;
    if (producer && pc.m < sm.n)
      fetch(sm, (chunk + MT_STAGES - 1) % MT_STAGES);
    mt_bar_wait(bar + k, (chunk / MT_STAGES) & 1);
    const MtCursor end = ends[k];
    const float* stage = ring + k * c.stg;
    const int a0 = cc.f & ~3;          // stage[f - a0] holds weight f
    const int b0 = cc.bo & ~3;         // stage[bst + q - b0] holds bias q
    bool synced = false;
    while (cc.f != end.f) {
      const int din = sm.w[cc.m][cc.l];
      const int dout = sm.w[cc.m][cc.l + 1];
      const bool last = cc.l == sm.nl[cc.m] - 1;
      const int i1 = end.m == cc.m && end.l == cc.l ? end.i : din;
      if (cc.i == 0) {
        map = mt_map(lr, dout, warp, lane);
#pragma unroll
        for (int q = 0; q < MT_ACC; ++q) acc[q] = 0.f;
      }
      const float* src = cc.l == 0 ? xs : ((cc.l - 1) & 1 ? hb1 : hb0);
      const int P = cc.l == 0 ? c.p_in : c.p_h;
      if (map.active) {
        const float* h = src + map.rbase * P;
        const float* ws = stage + (cc.f - a0);
#define MT_PIECE(TR, TO) \
  mt_piece<TR, TO>(acc, h, P, ws, dout, cc.i, i1, map.o0)
        MT_DISPATCH(map, MT_PIECE)
#undef MT_PIECE
      }
      cc.f += (i1 - cc.i) * dout;
      cc.i = i1;
      synced = false;
      if (i1 < din) continue;
      float* dst = cc.l & 1 ? hb1 : hb0;
      if (map.active) {
        float* d = dst + map.rbase * c.p_h;
        const float* bias = stage + c.bst + (cc.bo - b0);
#define MT_FINISH(TR, TO) \
  mt_finish<TR, TO>(acc, d, c.p_h, bias, dout, !last, map.o0)
        MT_DISPATCH(map, MT_FINISH)
#undef MT_FINISH
      }
      __syncthreads();               // the layer's outputs are written
      if (last) {
        head(cc.m, static_cast<const float*>(dst), c.p_h);
        __syncthreads();
      }
      synced = true;
      cc.bo += dout;
      cc.i = 0;
      if (++cc.l == sm.nl[cc.m]) {
        cc.l = 0;
        ++cc.m;
      }
    }
    if (!synced) __syncthreads();    // the stage is free to refill
  }
}

static inline int mt_round4(int v) { return (v + 3) & ~3; }

// The tile and ring of a launch over B rows, and its dynamic shared
// memory (extra_per_row bytes a row beside the buffers).
static inline cudaError_t mt_config(const MtModels& s, int B,
                                    size_t extra_per_row, MtCfg* c,
                                    size_t* smem) {
  static int n_sm[64];                // the SM count, asked once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (n_sm[dev] == 0) {
    e = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  const int want = (B + n_sm[dev] - 1) / n_sm[dev];
  c->R = 1;
  while (c->R < want && c->R < RT_MLP_TILE_ROWS) c->R <<= 1;
  int wmax = 1;
  for (int m = 0; m < s.n; ++m)
    for (int l = 1; l <= s.nl[m]; ++l)
      wmax = wmax > s.w[m][l] ? wmax : s.w[m][l];
  int chunks = 0, bmax = 0;
  for (MtCursor k{0, 0, 0, 0, 0}; k.m < s.n; ++chunks) {
    const MtCursor e = mt_chunk_end(s, k);
    if (e.bo > k.bo) {
      const int span = mt_round4(e.bo) - (k.bo & ~3);
      bmax = bmax > span ? bmax : span;
    }
    k = e;
  }
  c->p_in = mt_round4(s.w[0][0]);
  c->p_h = mt_round4(wmax);
  c->bst = RT_MLP_CHUNK + 4;
  c->stg = c->bst + bmax;
  c->n_stg = chunks < MT_STAGES ? chunks : MT_STAGES;
  for (;; c->R >>= 1) {              // a ring of many biases takes rows
    *smem = sizeof(float) * ((size_t)c->n_stg * c->stg +
                             (size_t)c->R * (c->p_in + 2 * c->p_h)) +
            extra_per_row * c->R;
    if (*smem <= MT_SMEM_MAX || c->R == 1) break;
  }
  return *smem <= MT_SMEM_MAX ? cudaSuccess : cudaErrorInvalidValue;
}

// Let a kernel take more than 48 KB of dynamic shared memory.
template <class K>
static inline cudaError_t mt_opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
