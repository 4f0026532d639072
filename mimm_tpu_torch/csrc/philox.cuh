// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R with R=10)
// and the flash-attention dropout draw shared by flash_attention_fwd.cu and
// flash_attention_bwd.cu.  mimm_tpu_torch/ops/philox.py is the same
// function in plain PyTorch.
//
// The keep bit of attention-probability element (b, h, i, j) is word j % 4
// of philox4x32_10(counter = (j / 4, i, b*H + h, 0), key = (seed, 0)),
// kept iff that word >= threshold = min(2^32 - 1, floor(rate * 2^32)) (the
// TPU kernel's rule, mimm_tpu/ops/flash_attention.py:58).  It depends on
// nothing but (seed, b*H + h, i, j), so every tiling draws the same bits.

#pragma once

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words for keys j4 .. j4+3 (j4 a multiple of 4) of query row i.
__device__ __forceinline__ uint4 dropout_words(unsigned seed, unsigned bh,
                                               unsigned i, unsigned j4) {
  return philox4x32_10(make_uint4(j4 >> 2, i, bh, 0u), make_uint2(seed, 0u));
}

__device__ __forceinline__ unsigned word_at(uint4 w, int t) {
  return t == 0 ? w.x : t == 1 ? w.y : t == 2 ? w.z : w.w;
}
