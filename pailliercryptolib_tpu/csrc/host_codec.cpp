// Native host codec: byte-string <-> limb/window array conversions.
//
// The analog of the reference's native data-marshalling layer
// (BigNumber::toBin/fromBin endian converters, ipcl/bignum.cpp:511-565, and
// the QAT buffer packing in ipcl/mod_exp.cpp:108-169): converting between
// arbitrary-precision integers (as little-endian byte strings) and the
// fixed-shape limb tensors consumed by the device kernels is the host-side
// hot path around every batched call, so it is implemented in C++ and
// exposed through ctypes (pailliercryptolib_tpu/utils/native.py).
//
// Layouts (must match pailliercryptolib_tpu/ops/limbs.py):
//   limbs:   radix 2^15, little-endian limb order, one uint32 per limb
//   windows: radix 2^4, MOST-significant window first, one uint32 each

#include <cstdint>
#include <cstring>

extern "C" {

// bytes [batch, nbytes] little-endian -> limbs [batch, num_limbs]
void pack_limbs(const uint8_t* bytes, int64_t batch, int64_t nbytes,
                uint32_t* out, int64_t num_limbs) {
  for (int64_t b = 0; b < batch; ++b) {
    const uint8_t* src = bytes + b * nbytes;
    uint32_t* dst = out + b * num_limbs;
    uint64_t acc = 0;
    int bits = 0;
    int64_t li = 0;
    for (int64_t i = 0; i < nbytes && li < num_limbs; ++i) {
      acc |= (uint64_t)src[i] << bits;
      bits += 8;
      while (bits >= 15 && li < num_limbs) {
        dst[li++] = (uint32_t)(acc & 0x7FFF);
        acc >>= 15;
        bits -= 15;
      }
    }
    while (li < num_limbs) {
      dst[li++] = (uint32_t)(acc & 0x7FFF);
      acc >>= 15;
    }
  }
}

// limbs [batch, num_limbs] (canonical, < 2^15) -> bytes [batch, nbytes] LE
void unpack_limbs(const uint32_t* limbs, int64_t batch, int64_t num_limbs,
                  uint8_t* out, int64_t nbytes) {
  for (int64_t b = 0; b < batch; ++b) {
    const uint32_t* src = limbs + b * num_limbs;
    uint8_t* dst = out + b * nbytes;
    std::memset(dst, 0, nbytes);
    uint64_t acc = 0;
    int bits = 0;
    int64_t bi = 0;
    for (int64_t i = 0; i < num_limbs; ++i) {
      acc |= (uint64_t)(src[i] & 0x7FFF) << bits;
      bits += 15;
      while (bits >= 8 && bi < nbytes) {
        dst[bi++] = (uint8_t)(acc & 0xFF);
        acc >>= 8;
        bits -= 8;
      }
    }
    while (bits > 0 && bi < nbytes) {
      dst[bi++] = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      bits -= 8;
    }
  }
}

// bytes [batch, nbytes] LE -> 4-bit windows [batch, nw], MS window first
void pack_windows(const uint8_t* bytes, int64_t batch, int64_t nbytes,
                  uint32_t* out, int64_t nw) {
  for (int64_t b = 0; b < batch; ++b) {
    const uint8_t* src = bytes + b * nbytes;
    uint32_t* dst = out + b * nw;
    for (int64_t w = 0; w < nw; ++w) {
      // window w (MS first) covers bits [4*(nw-1-w), 4*(nw-w))
      int64_t bit = 4 * (nw - 1 - w);
      int64_t byte = bit >> 3;
      uint32_t v = 0;
      if (byte < nbytes) v = src[byte];
      dst[w] = (bit & 7) ? (v >> 4) & 0xF : v & 0xF;
    }
  }
}

}  // extern "C"
