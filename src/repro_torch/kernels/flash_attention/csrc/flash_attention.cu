// K7 flash_attention: online-softmax attention with causal masking, a
// sliding window, GQA and a q position offset; f32 accumulation, the
// output in q's dtype (bf16 or f32).  Three designs, chosen by dtype and
// by Sq alone (launch_flash_attention below):
//
//   Sq <= FA_DECODE_MAX_SQ, bf16 or f32: fa_decode_kernel<T, D> +
//     fa_combine_kernel<T, D> (flash_decode.cu), a split-KV decode on
//     the CUDA cores;
//   bf16, Sq > FA_DECODE_MAX_SQ: fa_prefill_kernel<D> (flash_prefill.cu),
//     P V on the tensor cores (wgmma), the scores on the CUDA cores;
//   f32, Sq > FA_DECODE_MAX_SQ: fa_prefill_f32_kernel<D>
//     (flash_prefill_f32.cu), scores and P V as register-tiled f32 FMA
//     products on the CUDA cores.
//
// All three replace the TPU kernel repro/kernels/flash_attention/
// kernel.py:35 (_flash_kernel, launched by flash_attention_padded :113),
// which computes what models/attention.chunked_attention computes.  The
// port's LM path runs K7 for prefill (q_offset 0) and for every decode
// step (Sq = 1, q_offset = the cache index, skv = the cache length) of
// every layer; f32 operands come from the int8-cache configs and the f32
// Jamba run, which the models cast to f32.  Its expressions fix the
// numbers in every kernel: the scale after the dot (computed once on the
// host in double), the finite NEG_INF, the element masks kv_pos < skv,
// kv_pos <= q_pos and kv_pos > q_pos - window, alpha = exp(m_prev -
// m_new), acc / max(l, 1e-30), expf (no fast math).  Every score is one
// f32 FMA chain over d in ascending order.  Ragged q rows and kv rows
// past skv are masked in the kernels, so the wrapper pads nothing.
//
// Bounds.  Prefill is bound by bytes at a 512-token bf16 prefill and by
// operations at 2,048 (4 * D per live (q, kv) pair per head over 989
// TFLOP/s of bf16 tensor cores, or over 67 TFLOP/s of f32 CUDA cores,
// which bind the f32 prefill at 512); its designs run the scores as f32
// FMA chains in the reference's order (the tensor cores' sums are too
// coarse for them; see flash_prefill.cu) and overlap the next K/V tile's
// load with this one's products.  Decode is bound by bytes: each live
// key brings K and V for 4 * G * D operations, far below the card's
// operations per byte, over 3.35 TB/s; its design reads each live K/V
// row once per GQA group, with enough chunks to fill the SMs.  f32 keeps
// every product and sum in f32: its 1e-5 parity cannot hold through bf16
// tensor cores, and TF32 stays off.

#include "rt_types.h"

cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* o,
                                   const FlashArgs& a, int D, int bf16,
                                   cudaStream_t stream) {
  if (a.B == 0 || a.Sq == 0) return cudaSuccess;
  if (a.Sq <= FA_DECODE_MAX_SQ)
    return launch_flash_decode(q, k, v, o, a, D, bf16, stream);
  return bf16 ? launch_flash_prefill(q, k, v, o, a, D, stream)
              : launch_flash_prefill_f32(q, k, v, o, a, D, stream);
}
