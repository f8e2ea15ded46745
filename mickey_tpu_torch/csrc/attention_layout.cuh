// Addressing of the fp32-math attention kernels (flash_attention_f32.cu); the
// bf16 kernel (flash_attention_packed.cu) reads through TMA tensor maps.
//
// Where image b, head h of q, k, v and the output start (element offsets
// b * x_b + h * x_h from each base) and the element stride between their
// consecutive sequence rows (x_s); the D = 64 values of a row are contiguous
// and every row starts 16-byte aligned. The packed entries fill it for the
// head-major (B, S, 3C) qkv and the head-concat (B, S, C) output, the strided
// entries from the (B, H, S, D) views' strides.

#pragma once

template <typename In, typename Out>
struct AttnLayout {
  const In* q;
  const In* k;
  const In* v;
  Out* o;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};
